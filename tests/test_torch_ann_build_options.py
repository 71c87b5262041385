"""HNSW's two build options in the port, ``reverse_alg4=True`` (the
host-grouped Alg-4 reverse-edge prune) and ``build_pq="true"`` (the
PQ-guided level-0 walk), against the JAX package on the same numpy inputs,
on the CPU.

Tolerances: integer outputs (ids, merged rows, packed code bytes, graphs)
must be equal: random float data has no ties, and every sort breaks ties as
``lax.sort`` / ``lax.top_k`` do.  Distances are float32 sums in another
order: allclose at rtol=1e-5, atol=1e-5.  Sparse distances go through K1's
plain version.  The PQ-guided builds draw their codebooks from another RNG,
so for those the port's ``train_pq4`` is replaced by the JAX package's,
trained on the same guide with the same seed.  The port's own builds are held
at recall@10 >= 0.97 (the JAX package's bar for these options).
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as smat
import torch

import pecos_tpu_torch.ann.hnsw.model as tmodel
from pecos_tpu.ann import HNSW as JaxHNSW
from pecos_tpu.ann.hnsw import graph as jg
from pecos_tpu.ann.hnsw import pq as jpq
from pecos_tpu.ann.hnsw.model import _group_edges as jax_group_edges
from pecos_tpu_torch.ann import HNSW
from pecos_tpu_torch.ann.hnsw import graph as tg
from pecos_tpu_torch.ann.hnsw import pq as tpq

RTOL = ATOL = 1e-5
CPU = torch.device("cpu")


def _data(n=300, nq=40, d=16, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((nq, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    Q /= np.linalg.norm(Q, axis=1, keepdims=True)
    return X, Q


def _sparse(n, d, nnz, seed):
    """CSR rows with ``nnz`` random columns each (duplicates summed)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), nnz)
    cols = rng.integers(0, d, size=n * nnz)
    return smat.csr_matrix((rng.standard_normal(n * nnz).astype(np.float32), (rows, cols)), shape=(n, d))


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a) if dtype is None else np.array(a, dtype))


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def _exact_topk(X, Q, k, metric):
    d = 1.0 - Q @ X.T if metric == "ip" else ((Q[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    return np.argsort(d, axis=1, kind="stable")[:, :k]


def _recall(pred, true):
    return sum(len(set(p.tolist()) & set(t.tolist())) for p, t in zip(pred, true)) / true.size


def _adjacency(N, cap, seed, fill=0.6):
    """A random -1 padded adjacency and its distance co-array (INF at pads)."""
    rng = np.random.default_rng(seed)
    nbrs = rng.integers(0, N, size=(N, cap)).astype(np.int32)
    nbrs[rng.uniform(size=(N, cap)) > fill] = -1
    d = np.where(nbrs >= 0, rng.uniform(0.1, 2.0, size=(N, cap)), 3.4e38).astype(np.float32)
    return nbrs, d


def _forward_edges(N, B, M, seed):
    """A batch's forward selections with their distances; repeated dsts."""
    rng = np.random.default_rng(seed)
    sel = rng.integers(0, N // 3, size=(B, M)).astype(np.int32)
    sel[rng.uniform(size=(B, M)) > 0.8] = -1
    d = np.where(sel >= 0, rng.uniform(0.1, 2.0, size=(B, M)), 3.4e38).astype(np.float32)
    return sel, d


# (a) the packed-descriptor writers: each JAX *_packed function against the
# port's writer with packed=(desc, codes); ids, distances and desc bytes equal
N_PK, CAP_PK, S_PK = 90, 6, 4


def _packed_case(seed):
    nbrs, nd = _adjacency(N_PK, CAP_PK, seed)
    rng = np.random.default_rng(seed + 1)
    codes = rng.integers(0, 16, size=(N_PK, S_PK)).astype(np.uint8)
    desc = rng.integers(0, 256, size=(N_PK, CAP_PK * S_PK)).astype(np.uint8)  # rows not written keep theirs
    return nbrs, nd, codes, desc


def _run_packed(name):
    """(JAX outputs, port outputs) of one packed writer on the same inputs,
    each as (neighbors, dists or None, desc)."""
    nbrs, nd, codes, desc = _packed_case(seed=30)
    tn, td, tdesc, tcodes = _t(nbrs), _t(nd), _t(desc), _t(codes)
    packed = (tdesc, tcodes)
    j = lambda *a: tuple(jnp.asarray(x) for x in a)
    if name == "scatter_set_rows_packed_d":
        rows = np.array([3, 17, N_PK, 40, N_PK + 5], np.int64)
        ids = np.random.default_rng(31).integers(-1, N_PK, size=(5, 4)).astype(np.int32)
        d = np.random.default_rng(32).uniform(size=(5, 4)).astype(np.float32)
        want = jg.scatter_set_rows_packed_d(*j(nbrs, nd, desc, codes, rows, ids, d))
        tg.scatter_set_rows_d(tn, td, _t(rows), _t(ids, np.int64), _t(d), packed=packed)
    elif name == "reverse_merge_closest_packed":
        sel, sd = _forward_edges(N_PK, 16, 5, seed=33)
        src = np.arange(50, 66, dtype=np.int64)
        src[-3:] = N_PK
        want = jg.reverse_merge_closest_packed(*j(nbrs, nd, desc, codes, src, sel, sd))
        tg.reverse_merge_closest(tn, td, _t(src), _t(sel, np.int64), _t(sd), packed=packed)
    elif name == "reverse_merge_chunk_packed":
        new_ids, new_d = _forward_edges(N_PK, 96, 4, seed=34)
        want = jg.reverse_merge_chunk_packed(*j(nbrs, nd, desc, codes, new_ids, new_d), jnp.int32(80), B=32)
        tg.reverse_merge_chunk(tn, td, _t(new_ids), _t(new_d), 80, B=32, packed=packed)
    elif name == "scatter_set_rows_packed":
        rows = np.array([0, 5, N_PK, 89], np.int64)
        vals = np.random.default_rng(35).integers(-1, N_PK, size=(4, CAP_PK)).astype(np.int32)
        want = jg.scatter_set_rows_packed(*j(nbrs, desc, codes, rows, vals))
        want = (want[0], None, want[1])
        tg.scatter_set_rows(tn, _t(rows), _t(vals), packed=packed)
        td = None
    else:  # pack_rows_codes: the whole adjacency re-packed
        want = (None, None, jg.pack_rows_codes(jnp.asarray(codes), jnp.asarray(nbrs)))
        tn, td, tdesc = None, None, tg.pack_neighbor_codes(_t(nbrs), _t(codes), chunk=32)
    return want, (tn, td, tdesc)


@pytest.mark.parametrize("name", ["scatter_set_rows_packed_d", "reverse_merge_closest_packed", "reverse_merge_chunk_packed",
                                  "scatter_set_rows_packed", "pack_rows_codes"])
def test_packed_writers_equal_jax(name):
    want, got = _run_packed(name)
    for w, g in zip(want, got):
        if w is None:
            continue
        if np.asarray(w).dtype == np.float32:
            _close(g, w)
        else:
            assert g.dtype == torch.from_numpy(np.array(w)).dtype
            _equal(g, w)  # desc byte for byte, -1 slots holding node 0's codes


def test_group_edges_equals_jax():
    rng = np.random.default_rng(40)
    dst = np.concatenate([rng.integers(0, 50, size=300), np.full(150, 7)])  # node 7 gets three groups
    src = rng.integers(0, 400, size=len(dst))
    want = jax_group_edges(dst, src, 64)
    got = tmodel._group_edges(dst, src, 64)
    assert len(got) == len(want) == 3
    for (gr, gc), (wr, wc) in zip(got, want):
        assert gr.dtype == wr.dtype and gc.dtype == wc.dtype
        _equal(gr, wr)
        _equal(gc, wc)
    assert tmodel._group_edges(dst[:0], src[:0], 64) == jax_group_edges(dst[:0], src[:0], 64) == []


# (c) the reverse-edge prunes
def _prune_case(sparse, seed=41):
    """(jax feats, torch feats, neighbors, rows with pads N, new candidates)
    over 120 nodes: the candidates repeat existing neighbors and each other."""
    N, cap, A, K = 120, 8, 20, 12
    X = _sparse(N, 400, 12, seed) if sparse else _data(n=N, seed=seed)[0]
    fj = jg.build_sparse_feats(X) if sparse else jnp.asarray(X)
    ft = tg.build_sparse_feats(X, device=CPU) if sparse else torch.from_numpy(X)
    nbrs, _ = _adjacency(N, cap, seed)
    rng = np.random.default_rng(seed + 1)
    rows = rng.choice(N, size=A, replace=False).astype(np.int32)
    rows[-3:] = N  # pads
    cands = rng.integers(0, N, size=(A, K)).astype(np.int32)
    cands[:, 0] = nbrs[np.minimum(rows, N - 1), 0]  # an existing neighbor arrives again
    cands[:, 1] = cands[:, 2]  # an arrival twice
    cands[rng.uniform(size=(A, K)) > 0.8] = -1
    # no self-loops, as in a build (a node's distance to itself is rounding noise)
    nbrs[nbrs == np.arange(N)[:, None]] = -1
    cands[cands == rows[:, None]] = -1
    return fj, ft, nbrs, rows, cands


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("alg4", [False, True], ids=["closest", "alg4"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_scatter_prune_rows_equals_jax(sparse, alg4, metric):
    fj, ft, nbrs, rows, cands = _prune_case(sparse)
    fn = jg.scatter_prune_rows_alg4 if alg4 else jg.scatter_prune_rows
    want = fn(jnp.asarray(nbrs), fj, jnp.asarray(rows), jnp.asarray(cands), metric=metric)
    tn = _t(nbrs)
    got = tg.scatter_prune_rows(tn, ft, _t(rows), _t(cands), metric=metric, alg4=alg4)
    assert got is tn and tn.dtype == torch.int32  # in place
    _equal(tn, want)
    assert not (tn.numpy() == np.arange(120)[:, None]).all(axis=1).any()


@pytest.mark.parametrize("alg4", [False, True], ids=["closest", "alg4"])
def test_scatter_prune_rows_packed_equals_jax(alg4):
    fj, ft, nbrs, rows, cands = _prune_case(False, seed=42)
    codes = np.random.default_rng(43).integers(0, 16, size=(120, 3)).astype(np.uint8)
    desc = np.asarray(jg.pack_neighbor_codes(jnp.asarray(nbrs), jnp.asarray(codes)))
    want_n, want_desc = jg.scatter_prune_rows_packed(
        jnp.asarray(nbrs), jnp.asarray(desc), jnp.asarray(codes), fj, jnp.asarray(rows), jnp.asarray(cands),
        metric="l2", alg4=alg4,
    )
    tn, tdesc = _t(nbrs), _t(desc)
    tg.scatter_prune_rows(tn, ft, _t(rows), _t(cands), metric="l2", alg4=alg4, packed=(tdesc, _t(codes)))
    _equal(tn, want_n)
    _equal(tdesc, want_desc)


# (d) float32 builds equal to the JAX package's, edge for edge
_BASE = dict(M=8, efC=40, max_level_upper_bound=3)
BUILDS = {
    "dense-alg4-l2": (300, dict(_BASE, metric_type="l2", reverse_alg4=True)),
    "sparse-alg4-ip": (300, dict(_BASE, metric_type="ip", reverse_alg4=True, data_type="csr", build_batch_size=64)),
    "dense-pq-l2": (300, dict(_BASE, metric_type="l2", build_pq="true")),
    "dense-pq-scan-partial-l2": (300, dict(_BASE, metric_type="l2", build_pq="true", build_scan="true",
                                           refine_fraction=0.5, build_batch_size=64)),
    "sparse-pq-ip": (300, dict(_BASE, metric_type="ip", build_pq="true", data_type="csr", build_batch_size=64)),
    # both options: insertion and refine prune through scatter_prune_rows(alg4=True, packed=...)
    "dense-alg4-pq-l2": (300, dict(_BASE, metric_type="l2", reverse_alg4=True, build_pq="true")),
}


def _build_input(name, n):
    X, Q = _data(n=n)
    return (smat.csr_matrix(X), smat.csr_matrix(Q)) if name.startswith("sparse") else (X, Q)


def _jax_train_pq4(X, num_subspaces, iters, seed, feats_dev=None, device=None):
    """The JAX package's train_pq4 on the guide the port's build hands over."""
    pq = jpq.train_pq4(X, num_subspaces=num_subspaces, iters=iters, seed=seed,
                       feats_dev=jnp.asarray(feats_dev.float().numpy()))
    return tpq.ProductQuantizer4Bits(np.array(pq.codebooks), np.array(pq.codes), pq.dim)


@pytest.fixture(scope="module")
def builds():
    """name -> (X, Q, JAX model, port model) for every entry of BUILDS."""
    out = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(tmodel, "train_pq4", _jax_train_pq4)
    try:
        for name, (n, kw) in BUILDS.items():
            X, Q = _build_input(name, n)
            jm = JaxHNSW.train(X, build_dtype="float32", **kw)
            out[name] = (X, Q, jm, HNSW.train(X, build_dtype="float32", device="cpu", **kw))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("name", list(BUILDS))
def test_float32_build_equals_jax(builds, name):
    _, _, jm, tm = builds[name]
    np.testing.assert_array_equal(tm.node_levels, jm.node_levels)
    assert tm.entry_point == jm.entry_point
    assert tm.neighbors0.dtype == np.int32 and tm.upper_neighbors.shape == jm.upper_neighbors.shape
    np.testing.assert_array_equal(tm.neighbors0, jm.neighbors0)
    np.testing.assert_array_equal(tm.upper_neighbors, jm.upper_neighbors)


@pytest.mark.parametrize("name", list(BUILDS))
def test_folders_load_both_ways(builds, name, tmp_path):
    """A JAX-saved folder of each option's build searches alike in the port,
    and the port's folder alike in JAX."""
    _, Q, jm, tm = builds[name]
    want = jm.predict(Q, efS=30, topk=10)[0]
    jm.save(str(tmp_path / "jax"))
    _equal(HNSW.load(str(tmp_path / "jax"), device="cpu").predict(Q, efS=30, topk=10)[0], want)
    tm.save(str(tmp_path / "port"))
    _equal(JaxHNSW.load(str(tmp_path / "port")).predict(Q, efS=30, topk=10)[0], tm.predict(Q, efS=30, topk=10)[0])


# (e) the port's own builds (bfloat16 search copy when dense, its own PQ draws)
RECALL_BUILDS = {
    # tests/test_hnsw.py: test_pq_guided_build_recall, test_scan_build_recall, test_scan_build_partial_refine
    "pq": (dict(n=500, d=32, seed=11), dict(M=16, efC=80, metric_type="l2", build_pq="true")),
    "pq-scan": (dict(n=600, d=32, seed=13), dict(M=16, efC=80, metric_type="l2", build_batch_size=128,
                                                   build_scan="true", build_pq="true")),
    "pq-scan-partial": (dict(n=600, d=32, seed=17), dict(M=16, efC=80, metric_type="l2", build_batch_size=128,
                                                           build_scan="true", refine_fraction=0.3, build_pq="true")),
    "alg4-ip": (dict(n=400, d=16, seed=0), dict(M=16, efC=60, metric_type="ip", reverse_alg4=True)),
    "alg4-sparse-l2": (dict(n=300, d=16, seed=0), dict(M=8, efC=40, metric_type="l2", reverse_alg4=True,
                                                         data_type="csr", build_batch_size=64)),
    "pq-sparse-ip": (dict(n=400, d=16, seed=0), dict(M=16, efC=60, metric_type="ip", build_pq="true",
                                                       data_type="csr", build_batch_size=128)),
}


@pytest.mark.parametrize("name", list(RECALL_BUILDS))
def test_recall_of_the_ports_builds(name):
    data_kw, kw = RECALL_BUILDS[name]
    X, Q = _data(nq=50, **data_kw)
    sparse = kw.get("data_type") == "csr"
    model = HNSW.train(smat.csr_matrix(X) if sparse else X, device="cpu", **kw)
    ids, dists = model.predict(smat.csr_matrix(Q) if sparse else Q, efS=100, topk=10)
    rec = _recall(ids, _exact_topk(X, Q, 10, kw["metric_type"]))
    assert rec >= 0.97, f"{name}: recall@10 {rec}"
    assert (np.diff(dists, axis=1) >= -1e-5).all()


# (g) what the options refuse or change
def test_sparse_input_with_both_options_raises():
    X, _ = _data(n=60)
    with pytest.raises(ValueError, match="reverse_alg4.*build_pq.*F14"):
        HNSW.train(smat.csr_matrix(X), reverse_alg4=True, build_pq="true", data_type="csr", device="cpu")
    # dense input takes both (the JAX package's scatter_prune_rows_packed with alg4)
    model = HNSW.train(X, M=4, efC=16, reverse_alg4=True, build_pq="true", device="cpu")
    assert model.neighbors0.shape == (60, 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            HNSW.train(X, M=4, efC=10, reverse_alg4=True, device="cuda")


def test_alg4_ignores_scan_mode(caplog):
    """reverse_alg4 has no co-arrays, so build_scan='true' warns and builds
    eagerly, as the JAX package does."""
    X, _ = _data(n=120)
    kw = dict(M=4, efC=16, metric_type="l2", reverse_alg4=True, build_dtype="float32", device="cpu")
    eager = HNSW.train(X, build_scan="false", **kw)
    with caplog.at_level(logging.WARNING, logger=tmodel.LOGGER.name):
        forced = HNSW.train(X, build_scan="true", **kw)
    assert "build_scan requires the device-resident (fast) path" in caplog.text
    np.testing.assert_array_equal(forced.neighbors0, eager.neighbors0)
    np.testing.assert_array_equal(forced.upper_neighbors, eager.upper_neighbors)
