"""The port's Newton-CG solvers against the JAX package's on the same numpy
inputs (CPU).

Tolerances: the losses are elementwise float32, equal within 1e-6.  One
Newton iteration agrees to float rounding (atol 1e-5 on |W| ~ 1).  A full
solve on a well-conditioned block (more rows than features, unit-scale
features) agrees within atol 2e-4: the two packages sum matmuls in another
order, and where a label's stopping test lands on a different iteration W
moves by about eps times its gradient scale (ROADMAP F5).  The sparse-rows
layouts are held to the bars of ``tests/test_mlmodel.py:277`` (rtol 2e-3,
atol 2e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pecos_tpu.xmc import solvers as jsol
from pecos_tpu_torch.xmc import solvers

LOSSES = ("sqhinge", "logistic", "l1hinge")


def _block(seed=0, N=96, D=8, Lb=8):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, D)).astype(np.float32)
    X[:, -1] = 1.0  # the bias column
    W_true = rng.standard_normal((D, Lb)).astype(np.float32)
    y = np.where(X @ W_true + 0.3 * rng.standard_normal((N, Lb)) > 0.5, 1.0, -1.0).astype(np.float32)
    codes = np.where(y > 0, 1, np.where(rng.uniform(size=(N, Lb)) < 0.8, 2, 0)).astype(np.uint8)
    return X, y, codes


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("loss", LOSSES)
def test_losses_match_jax(loss):
    rng = np.random.default_rng(1)
    ym = np.concatenate([np.linspace(-3, 3, 601), [0.99, 0.995, 1.0, 1.01, 0.8, 0.81]]).astype(np.float32)
    y = np.where(rng.uniform(size=ym.shape) < 0.5, 1.0, -1.0).astype(np.float32)
    c = rng.uniform(0.5, 2.0, size=ym.shape).astype(np.float32)
    for gamma in (0.2, 0.01):
        pairs = [
            (jsol._xi(loss, jnp.asarray(ym), gamma), solvers._xi(loss, _t(ym), gamma)),
            (jsol._dxi(loss, jnp.asarray(y), jnp.asarray(ym), gamma), solvers._dxi(loss, _t(y), _t(ym), gamma)),
            (jsol._hess_w(loss, jnp.asarray(c), jnp.asarray(ym), gamma), solvers._hess_w(loss, _t(c), _t(ym), gamma)),
        ]
        for want, got in pairs:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("max_newton,atol", [(1, 1e-5), (20, 2e-4)])
def test_solve_block_matches_jax(loss, max_newton, atol):
    X, y, codes = _block()
    c = np.where(codes > 0, 1.0, 0.0).astype(np.float32)
    want = np.asarray(jsol.solve_block(jnp.asarray(X), jnp.asarray(y), jnp.asarray(c), loss=loss, max_newton=max_newton))
    got = solvers.solve_block(_t(X), _t(y), _t(c), loss=loss, max_newton=max_newton).numpy()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("with_R", [False, True])
def test_solve_block_coded_matches_jax(loss, with_R):
    X, _, codes = _block(seed=2)
    R = np.random.default_rng(3).uniform(0.5, 2.0, size=codes.shape).astype(np.float32) if with_R else None
    Cp, Cn = np.float32(1.5), np.float32(0.75)
    want = np.asarray(jsol.solve_block_coded(
        jnp.asarray(X), jnp.asarray(codes), Cp, Cn, None if R is None else jnp.asarray(R), loss=loss, has_R=with_R
    ))
    got = solvers.solve_block_coded(_t(X), _t(codes), float(Cp), float(Cn), None if R is None else _t(R), loss=loss).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def _bucket(seed=4, Cb=3, P=48, xcap=6, F2=10, ns=4):
    """A bucket of Cb clusters: P local rows of xcap nonzeros over F2 local
    features (pad id F2, value 0 in the last slot of half the rows)."""
    rng = np.random.default_rng(seed)
    ids = np.stack([np.stack([rng.choice(F2, xcap, replace=False) for _ in range(P)]) for _ in range(Cb)]).astype(np.int32)
    vals = rng.standard_normal((Cb, P, xcap)).astype(np.float32)
    ids[:, ::2, -1], vals[:, ::2, -1] = F2, 0.0
    y = np.where(rng.uniform(size=(Cb, P, ns)) < 0.35, 1.0, -1.0).astype(np.float32)
    c = np.where(rng.uniform(size=(Cb, P, ns)) < 0.85, 1.0, 0.0).astype(np.float32)
    return ids, vals, y, c


@pytest.mark.parametrize("loss", ["sqhinge", "l1hinge"])
def test_solve_cluster_bucket_matches_jax_and_per_cluster(loss):
    ids, vals, y, c = _bucket()
    F2 = 10
    want = np.asarray(jsol.solve_cluster_bucket(*(jnp.asarray(a) for a in (ids, vals, y, c)), F2=F2, loss=loss))
    got = solvers.solve_cluster_bucket(*(_t(a) for a in (ids, vals, y, c)), F2=F2, loss=loss).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    # the batched core equals one solve_block per cluster
    for k in range(ids.shape[0]):
        Xk = np.zeros((ids.shape[1], F2 + 1), np.float32)
        np.add.at(Xk, (np.arange(ids.shape[1])[:, None], ids[k]), vals[k])
        Wk = solvers.solve_block(_t(Xk[:, :F2]), _t(y[k]), _t(c[k]), loss=loss).numpy()
        np.testing.assert_allclose(got[k], Wk, atol=1e-5, rtol=0)


@pytest.mark.parametrize("loss", ["sqhinge", "logistic"])
def test_solve_sparse_rows_layouts(monkeypatch, loss):
    """Both layouts against the JAX package's dense layout and each other."""
    rng = np.random.default_rng(3)
    P, xcap, Db, ns = 120, 10, 50, 6
    ids = rng.integers(0, Db, size=(P, xcap)).astype(np.int32)
    vals = rng.standard_normal((P, xcap)).astype(np.float32)
    y = np.where(rng.uniform(size=(P, ns)) < 0.25, 1.0, -1.0).astype(np.float32)
    c = np.where(y > 0, 1.0, 0.5).astype(np.float32)
    want = np.asarray(jsol.solve_sparse_rows(*(jnp.asarray(a) for a in (ids, vals, y, c)), Db=Db, loss=loss))
    args = [_t(a) for a in (ids, vals, y, c)]
    W_dense = solvers.solve_sparse_rows(*args, Db=Db, loss=loss).numpy()
    monkeypatch.setattr(solvers, "_GLOBAL_DENSE_BUDGET", 0)  # the chunked gather/scatter layout
    monkeypatch.setattr(solvers, "_SCATTER_CHUNK_ELEMENTS", 7 * xcap * ns)  # several chunks, the last one short
    W_scatter = solvers.solve_sparse_rows(*args, Db=Db, loss=loss).numpy()
    assert W_dense.shape == W_scatter.shape == (Db, ns)
    for got in (W_dense, W_scatter):
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(W_scatter, W_dense, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("loss", ["sqhinge", "logistic"])
def test_solve_sparse_rows_chunked_fixed_order(monkeypatch, loss):
    """F8: the chunked layout adds in a fixed order, without index_add_ or
    scatter_add_ (float atomics on a GPU): at a tight solve it gives the
    dense layout's W, and two solves are bit-equal.  Ids repeat within a row
    and across rows, and padded slots point at Db."""
    rng = np.random.default_rng(8)
    P, xcap, Db, ns = 150, 12, 40, 5
    ids = rng.integers(0, Db, size=(P, xcap)).astype(np.int32)
    ids[::4, -3:] = Db
    vals = np.where(ids < Db, rng.standard_normal((P, xcap)), 0.0).astype(np.float32)
    y = np.where(rng.uniform(size=(P, ns)) < 0.3, 1.0, -1.0).astype(np.float32)
    c = rng.uniform(0.5, 1.5, size=(P, ns)).astype(np.float32)
    args = [_t(a) for a in (ids, vals, y, c)]
    tight = dict(eps=1e-6, max_newton=60, cg_max=60)
    W_dense = solvers.solve_sparse_rows(*args, Db=Db, loss=loss, **tight).numpy()

    def atomic(*a, **k):
        raise AssertionError("the chunked layout must not add with atomics")

    monkeypatch.setattr(torch.Tensor, "index_add_", atomic)
    monkeypatch.setattr(torch.Tensor, "scatter_add_", atomic)
    monkeypatch.setattr(solvers, "_GLOBAL_DENSE_BUDGET", 0)
    monkeypatch.setattr(solvers, "_SCATTER_CHUNK_ELEMENTS", 40 * xcap * ns)  # 4 chunks, the last one short
    W1, W2 = (solvers.solve_sparse_rows(*args, Db=Db, loss=loss, **tight).numpy() for _ in range(2))
    np.testing.assert_array_equal(W1, W2)
    np.testing.assert_allclose(W1, W_dense, rtol=2e-3, atol=2e-4)


def test_run_sums_and_segment_sum():
    """run_sums against numpy's sums of the same runs; segment_sum against
    np.add.at, for one problem and a batch of two."""
    from pecos_tpu_torch.utils.torch_util import run_sums, segment_sum

    rng = np.random.default_rng(9)
    src = rng.standard_normal((2, 50, 3)).astype(np.float32)
    cuts = np.sort(rng.choice(np.arange(1, 50), size=(2, 6), replace=False), axis=1)
    starts = np.concatenate([np.zeros((2, 1), np.int64), cuts], axis=1)
    ends = np.concatenate([cuts, np.full((2, 1), 50, np.int64)], axis=1)
    got = run_sums(_t(src), _t(starts), _t(ends)).numpy()
    want = np.stack([[src[b, s:e].sum(0) for s, e in zip(starts[b], ends[b])] for b in range(2)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    index = rng.integers(0, 7, size=(2, 50))
    want = np.zeros((2, 9, 3), np.float32)
    for b in range(2):
        np.add.at(want[b], index[b], src[b])
    np.testing.assert_allclose(segment_sum(_t(index), _t(src), 9).numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(segment_sum(_t(index[0]), _t(src[0]), 9).numpy(), want[0], rtol=1e-6, atol=1e-6)


def test_prune_topk_and_count_match_jax():
    """Equal indices, ties included: the zeros left by the threshold and
    repeated magnitudes keep the lower feature id first, as lax.top_k does."""
    rng = np.random.default_rng(5)
    W = rng.choice(np.array([-0.5, -0.2, 0.05, 0.2, 0.5, 0.9], np.float32), size=(40, 12))
    W[:, 3] = 0.0
    for thr, K in ((0.0, 8), (0.3, 8), (0.3, 40), (1.0, 4)):
        j_idx, j_vals = (np.asarray(a) for a in jsol.prune_topk_device(jnp.asarray(W), thr, K))
        t_idx, t_vals = solvers.prune_topk_device(_t(W), thr, K)
        np.testing.assert_array_equal(t_idx.numpy(), j_idx)
        np.testing.assert_array_equal(t_vals.numpy(), j_vals)
        assert int(solvers.count_above_threshold(_t(W), thr)) == int(jsol.count_above_threshold(jnp.asarray(W), thr))


def test_loss_names_and_sync_count():
    for st in ("L2R_L2LOSS_SVC_DUAL", "l2r_l2loss_svc_primal", "L2R_L1LOSS_SVC_DUAL", "L2R_LR_DUAL", "L2R_LR_PRIMAL"):
        assert solvers.loss_name(st) == jsol.loss_name(st)
    with pytest.raises(ValueError, match="unknown solver_type"):
        solvers.loss_name("MCSVM")
    # one host read of the convergence flags per Newton iteration but the last
    X, y, codes = _block()
    c = np.where(codes > 0, 1.0, 0.0).astype(np.float32)
    before = solvers.all_converged.syncs
    solvers.solve_block(_t(X), _t(y), _t(c), max_newton=3, eps=0.0)
    assert solvers.all_converged.syncs - before == 2
