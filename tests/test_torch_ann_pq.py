"""4-bit PQ and the HNSW-PQ4 model: the port (pecos_tpu_torch.ann.hnsw.pq,
HNSWProductQuantizer4Bits) against the JAX package on the same numpy inputs,
on the CPU.

Tolerances: LUTs, centroids and distances are float32 sums taken in another
order, so allclose at rtol=1e-5, atol=1e-5; codes and searched ids must be
equal.  The port's codebook draws come from a torch.Generator (other numbers
than jax.random), so the k-means is compared on JAX's own starting indices and
the models are compared on JAX's trained codebooks and codes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as smat
import torch

from pecos_tpu.ann.hnsw import graph as jg
from pecos_tpu.ann.hnsw import pq as jpq
from pecos_tpu.ann.hnsw.model import HNSWProductQuantizer4Bits as JaxPQ4
from pecos_tpu_torch.ann.hnsw import HNSW, HNSWProductQuantizer4Bits
from pecos_tpu_torch.ann.hnsw import graph as tg
from pecos_tpu_torch.ann.hnsw import pq as tpq

RTOL = ATOL = 1e-5
CPU = torch.device("cpu")


def _data(n=300, nq=30, d=32, seed=5):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((nq, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    Q /= np.linalg.norm(Q, axis=1, keepdims=True)
    return X, Q


def _t(a):
    return torch.from_numpy(np.array(a))


def _exact_topk(X, Q, k):
    return np.argsort(((Q[:, None, :] - X[None, :, :]) ** 2).sum(-1), axis=1, kind="stable")[:, :k]


def _recall(pred, true):
    return sum(len(set(p.tolist()) & set(t.tolist())) for p, t in zip(pred, true)) / true.size


@pytest.fixture(scope="module")
def jax_pq4():
    """A JAX-trained HNSW-PQ4 model (l2, 16 subspaces) and its queries: (X, Q, model)."""
    X, Q = _data()
    model = JaxPQ4.train(
        X,
        train_params={
            "hnsw_params": {"M": 16, "efC": 60, "metric_type": "l2", "max_level_upper_bound": 3},
            "num_subspaces": 16,
            "kmeans_iters": 8,
        },
    )
    return X, Q, model


def _port_of(model, device=CPU):
    """The port's HNSW-PQ4 over the arrays of a JAX-built one."""
    h = model.hnsw
    hnsw = HNSW(h.feats, h.neighbors0, h.upper_neighbors, h.node_levels, h.entry_point, h.metric, device=device)
    pq = tpq.ProductQuantizer4Bits(np.asarray(model.pq.codebooks), np.asarray(model.pq.codes), model.pq.dim)
    return HNSWProductQuantizer4Bits(hnsw, pq)


def test_pq_apply_lut_matches_direct_indexing_and_jax():
    rng = np.random.default_rng(0)
    B, K, S = 4, 13, 8
    lut = rng.standard_normal((B, S, 16)).astype(np.float32)
    c = rng.integers(0, 16, size=(B, K, S)).astype(np.uint8)
    ref = lut[np.arange(B)[:, None, None], np.arange(S)[None, None, :], c].sum(-1)
    got = tpq.pq_apply_lut(_t(lut), _t(c))
    assert got.shape == (B, K) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(jpq.pq_apply_lut(jnp.asarray(lut), jnp.asarray(c))), rtol=RTOL, atol=ATOL)
    ids = rng.integers(-1, 40, size=(B, K)).astype(np.int32)
    codes = rng.integers(0, 16, size=(40, S)).astype(np.uint8)
    want = jpq.pq_gather_dist(jnp.asarray(lut), jnp.asarray(codes), jnp.asarray(ids), ip_offset=1.0)
    np.testing.assert_allclose(tpq.pq_gather_dist(_t(lut), _t(codes), _t(ids), ip_offset=1.0).numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_kmeans16_on_jax_init_indices():
    """Lloyd rounds from the starting centroids JAX's train_pq4 draws: the
    same centroids."""
    rng = np.random.default_rng(1)
    S, n, d, iters = 6, 200, 3, 7
    Xs = rng.standard_normal((n, S, d)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(4), S)
    init = np.stack([np.asarray(jax.random.choice(k, n, shape=(16,), replace=False)) for k in keys])
    want = jax.vmap(lambda xs, k: jpq._kmeans16(xs, k, iters), in_axes=(1, 0))(jnp.asarray(Xs), keys)
    got = tpq._kmeans16(_t(Xs.transpose(1, 0, 2)), _t(init), iters)
    assert got.shape == (S, 16, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("s0", [0, 40, 95])  # the last start is clamped, as lax.dynamic_slice clamps it
def test_encode_chunk_device(s0):
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((100, 14)).astype(np.float32)  # 14 columns pad to 4 x 4
    cent = rng.standard_normal((4, 16, 4)).astype(np.float32)
    want = jpq._encode_chunk_device(jnp.asarray(feats), jnp.asarray(cent), jnp.int32(s0), S=4, d_sub=4, chunk=32)
    got = tpq._encode_chunk_device(_t(feats), _t(cent), s0, S=4, d_sub=4, chunk=32)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_build_lut_host_and_device(jax_pq4, metric):
    _, Q, model = jax_pq4
    pq = tpq.ProductQuantizer4Bits(np.asarray(model.pq.codebooks), np.asarray(model.pq.codes), model.pq.dim)
    want = jpq.build_lut(model.pq, Q, metric)
    np.testing.assert_allclose(tpq.build_lut(pq, Q, metric), want, rtol=RTOL, atol=ATOL)
    got = tpq.build_lut_device(_t(pq.codebooks), _t(Q), metric=metric)
    np.testing.assert_allclose(got.numpy(), np.asarray(jpq.build_lut_device(jnp.asarray(pq.codebooks), jnp.asarray(Q), metric=metric)), rtol=RTOL, atol=ATOL)


def test_train_pq4_codes_are_nearest_centroids():
    """The port's own codebooks (torch.Generator draws): every code names the
    nearest centroid of its subspace, from the host and the device features,
    and with a training sample smaller than the corpus."""
    X, _ = _data(n=250, d=30, seed=3)
    Xs = tpq._pad_dim(X, 8).reshape(250, 8, 4)
    trained = []
    for kw in (dict(), dict(feats_dev=torch.from_numpy(X)), dict(max_train_points=100)):
        pq = tpq.train_pq4(X, num_subspaces=8, iters=5, seed=2, device="cpu", **kw)
        assert pq.codebooks.shape == (8, 16, 4) and pq.codes.shape == (250, 8) and pq.dim == 30
        d = ((Xs[:, :, None, :] - pq.codebooks[None]) ** 2).sum(-1)
        np.testing.assert_array_equal(pq.codes, d.argmin(-1))
        trained.append(pq)
    # one seed, one set of draws: the codebooks do not depend on where the features lie
    np.testing.assert_array_equal(trained[0].codebooks, trained[1].codebooks)


def test_pq_search_on_jax_graph_packed_and_unpacked(jax_pq4):
    """The PQ beam search over a JAX-built graph with JAX's codes gives JAX's
    ids, and the packed neighbor codes give the same ids as the unpacked."""
    _, Q, model = jax_pq4
    g = model.hnsw
    lut = jpq.build_lut(model.pq, Q, "l2")
    entry = np.random.default_rng(6).integers(0, g.feats.shape[0], size=(len(Q), 1)).astype(np.int32)
    codes, nbrs = np.asarray(model.pq.codes), np.asarray(g.neighbors0)
    want, _ = jg.batch_search_level_pq(jnp.asarray(codes), jnp.asarray(nbrs), jnp.asarray(lut), jnp.asarray(entry), ef=40, max_steps=160)
    got, got_d = tg.batch_search_level_pq(_t(codes), _t(nbrs), _t(lut), _t(entry), ef=40, max_steps=160)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    packed = tg.pack_neighbor_codes(_t(nbrs), _t(codes))
    got_p, got_pd = tg.batch_search_level_pq_packed(_t(codes), _t(nbrs), packed, _t(lut), _t(entry), ef=40, max_steps=160)
    np.testing.assert_array_equal(got_p.numpy(), got.numpy())
    np.testing.assert_array_equal(got_pd.numpy(), got_d.numpy())


def test_pq4_predict_matches_jax(jax_pq4):
    _, Q, model = jax_pq4
    port = _port_of(model)
    for packed in ("false", "true"):
        want_i, want_d = model.predict(Q, efS=80, topk=10, num_rerank=60, packed=packed)
        got_i, got_d = port.predict(Q, efS=80, topk=10, num_rerank=60, packed=packed)
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_allclose(got_d, want_d, rtol=RTOL, atol=ATOL)


def test_pq4_train_recall_and_from_hnsw():
    X, Q = _data(seed=5)
    model = HNSWProductQuantizer4Bits.train(
        X,
        train_params={
            "hnsw_params": {"M": 16, "efC": 60, "metric_type": "l2", "max_level_upper_bound": 3},
            "num_subspaces": 16,
            "kmeans_iters": 8,
        },
        device="cpu",
    )
    ids, dists = model.predict(Q, efS=80, topk=10, num_rerank=60)
    assert _recall(ids, _exact_topk(X, Q, 10)) >= 0.9
    assert (np.diff(dists, axis=1) >= -1e-5).all()
    grafted = HNSWProductQuantizer4Bits.from_hnsw(model.hnsw, num_subspaces=16, kmeans_iters=8)
    np.testing.assert_array_equal(grafted.pq.codes, model.pq.codes)  # same features, same seed
    np.testing.assert_array_equal(grafted.predict(Q, efS=80, topk=10, num_rerank=60)[0], ids)
    sparse = HNSW.train(smat.csr_matrix(X[:100]), M=8, efC=20, data_type="csr", device="cpu")
    with pytest.raises(ValueError, match="dense features"):
        HNSWProductQuantizer4Bits.from_hnsw(sparse)


def test_pq4_folders_load_both_ways(jax_pq4, tmp_path):
    _, Q, model = jax_pq4
    want_i, _ = model.predict(Q, efS=80, topk=10, num_rerank=60)
    model.save(str(tmp_path / "jax"))
    port = HNSWProductQuantizer4Bits.load(str(tmp_path / "jax"), device="cpu")
    got_i, _ = port.predict(Q, efS=80, topk=10, num_rerank=60)
    assert (got_i == want_i).mean() >= 0.99
    port.save(str(tmp_path / "port"))
    back = JaxPQ4.load(str(tmp_path / "port"))
    np.testing.assert_array_equal(back.pq.codes, model.pq.codes)
    assert (back.predict(Q, efS=80, topk=10, num_rerank=60)[0] == got_i).mean() >= 0.99
    again = HNSWProductQuantizer4Bits.load(str(tmp_path / "port"), device="cpu")
    assert again.get_pred_params().num_rerank == port.get_pred_params().num_rerank
    np.testing.assert_array_equal(again.predict(Q, efS=80, topk=10, num_rerank=60)[0], got_i)
