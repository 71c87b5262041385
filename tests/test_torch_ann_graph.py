"""HNSW graph primitives: the port (pecos_tpu_torch.ann.hnsw.graph) against the
JAX package (pecos_tpu.ann.hnsw.graph) on the same numpy inputs, on the CPU.

Tolerances: distances are float32 sums taken in another order (XLA's against
torch's), so allclose at rtol=1e-5, atol=1e-5; integer outputs (node ids,
selections, merged adjacency rows) must be equal, since random float data has
no ties and every top-k and sort breaks ties as ``lax.top_k`` / ``lax.sort`` do.
The sparse distances go through K1's plain version, which is what the CUDA
kernel is held against on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as smat
import torch

from pecos_tpu.ann import HNSW as JaxHNSW
from pecos_tpu.ann.hnsw import graph as jg
from pecos_tpu_torch.ann.hnsw import graph as tg
from pecos_tpu_torch.ops.intersect import intersect_scores

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


def _feats(X, sparse):
    """The same features for both packages: (jax, torch)."""
    if sparse:
        return jg.build_sparse_feats(X), tg.build_sparse_feats(X, device=CPU)
    return jnp.asarray(X), torch.from_numpy(X)


def _queries(Q, sparse):
    """Query blocks for both packages: (jax, torch)."""
    if sparse:
        sf = jg.build_sparse_feats(Q)
        return jg.SparseBlock(sf.ids, sf.vals, sf.sq), tg.build_sparse_feats(Q, device=CPU)[:]
    return jnp.asarray(Q), torch.from_numpy(Q)


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a) if dtype is None else np.array(a, dtype))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.fixture(scope="module")
def jax_graph():
    """A graph the JAX package built (float32 build copy), with CSR twins of
    its features and queries: (X, Q, Xs, Qs, model)."""
    X, Q = _data()
    model = JaxHNSW.train(X, M=8, efC=40, metric_type="l2", max_level_upper_bound=3, build_dtype="float32")
    return X, Q, smat.csr_matrix(X), smat.csr_matrix(Q), model


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_gather_dist(sparse, metric):
    X, Q = _data(n=120, nq=24)
    if sparse:
        X, Q = smat.csr_matrix(X), smat.csr_matrix(Q)
    fj, ft = _feats(X, sparse)
    qj, qt = _queries(Q, sparse)
    ids = np.random.default_rng(1).integers(-1, 120, size=(24, 37)).astype(np.int32)
    want = jg.gather_dist(qj, fj, jnp.asarray(ids), metric)
    got = tg.gather_dist(qt, ft, _t(ids, np.int64), metric)
    assert got.dtype == torch.float32 and got.shape == (24, 37)
    _close(got, want)


def test_pairwise_dist():
    X, Q = _data(n=50, nq=7)
    for metric in ("ip", "l2"):
        _close(tg.pairwise_dist(_t(Q), _t(X), metric), jg.pairwise_dist(jnp.asarray(Q), jnp.asarray(X), metric))


def test_sparse_gather_dots_through_k1_plain_version():
    """Rows of another width than the queries, pads SPARSE_PAD_ID on both sides."""
    X = _sparse(200, 3000, 40, seed=2)
    Q = _sparse(16, 3000, 12, seed=3)
    fj, ft = _feats(X, True)
    qj, qt = _queries(Q, True)
    assert ft.shape[1] != qt.ids.shape[1]
    ids = np.random.default_rng(4).integers(0, 200, size=(16, 50)).astype(np.int32)
    before = intersect_scores.launches
    got = tg._sparse_gather_dots(qt, ft, _t(ids, np.int64))
    assert intersect_scores.launches == before  # CPU tensors: the plain version, no launch
    _close(got, jg._sparse_gather_dots(qj, fj, jnp.asarray(ids)))


def _search_both(jax_graph, metric, sparse, B=None, ef=30, expand=4):
    X, Q, Xs, Qs, model = jax_graph
    Qb = Qs if sparse else Q
    if B:
        Qb = Qb[:B]
    fj, ft = _feats(Xs if sparse else X, sparse)
    qj, qt = _queries(Qb, sparse)
    n = Qb.shape[0]
    uppers = [model.upper_neighbors[l - 1] for l in range(model.upper_neighbors.shape[0], 0, -1)]
    entry = np.full(n, model.entry_point, np.int32)
    cur_j = jg.batch_greedy_descent_multi(fj, tuple(jnp.asarray(u) for u in uppers), qj, jnp.asarray(entry), metric=metric, max_steps=64)
    cur_t = tg.batch_greedy_descent_multi(ft, [_t(u) for u in uppers], qt, _t(entry), metric=metric, max_steps=64)
    out_j = jg.batch_search_level(
        jg.DeviceGraph(fj, jnp.asarray(model.neighbors0), metric), qj, cur_j[:, None],
        ef=ef, max_steps=4 * ef, expand=expand,
    )
    g = tg.DeviceGraph(ft, _t(model.neighbors0), metric)
    out_t = tg.batch_search_level(g, qt, cur_t[:, None], ef=ef, max_steps=4 * ef, expand=expand)
    return (cur_j, out_j), (cur_t, out_t)


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_greedy_descent_and_search_on_jax_graph(jax_graph, sparse, metric):
    (cur_j, (ids_j, d_j)), (cur_t, (ids_t, d_t)) = _search_both(jax_graph, metric, sparse)
    _equal(cur_t, cur_j)
    assert ids_t.dtype == torch.int64 and ids_t.shape == (40, 30)
    _equal(ids_t, ids_j)
    _close(torch.where(ids_t >= 0, d_t, 0.0), np.where(np.asarray(ids_j) >= 0, d_j, 0.0))


def test_single_level_greedy_descent(jax_graph):
    X, Q, _, _, model = jax_graph
    top = model.upper_neighbors[-1]
    entry = np.full(len(Q), model.entry_point, np.int32)
    want = jg.batch_greedy_descent(jg.DeviceGraph(jnp.asarray(X), jnp.asarray(top), "l2"), jnp.asarray(Q), jnp.asarray(entry), max_steps=64)
    got = tg.batch_greedy_descent(tg.DeviceGraph(_t(X), _t(top), "l2"), _t(Q), _t(entry), max_steps=64)
    _equal(got, want)


def test_device_gated_steps_give_the_same_search(jax_graph, monkeypatch):
    """Reading the loop flag every 5th step (the steps between gated on the
    device, as on a GPU) gives the every-step result with fewer host reads."""
    _, (cur_1, out_1) = _search_both(jax_graph, "l2", False, expand=2)
    reads_1 = tg.read_flag.syncs
    monkeypatch.setitem(tg.CHECK_EVERY, "cpu", 5)
    _, (cur_5, out_5) = _search_both(jax_graph, "l2", False, expand=2)
    reads_5 = tg.read_flag.syncs - reads_1
    _equal(cur_5, cur_1)
    _equal(out_5[0], out_1[0])
    _equal(out_5[1], out_1[1])
    assert 0 < reads_5


def test_search_entry_wider_than_beam():
    """More entry points than ef: the beam starts from the ef closest."""
    X, Q = _data(n=80, nq=6)
    nbrs = np.random.default_rng(5).integers(-1, 80, size=(80, 6)).astype(np.int32)
    entry = np.random.default_rng(6).integers(-1, 80, size=(6, 12)).astype(np.int32)
    want = jg.batch_search_level(jg.DeviceGraph(jnp.asarray(X), jnp.asarray(nbrs), "ip"), jnp.asarray(Q), jnp.asarray(entry), ef=8, max_steps=40)
    got = tg.batch_search_level(tg.DeviceGraph(_t(X), _t(nbrs), "ip"), _t(Q), _t(entry), ef=8, max_steps=40)
    _equal(got[0], want[0])
    _close(got[1], want[1])


def _candidates(n, B, E, seed, n_pad=5):
    """Search-shaped candidate lists: distinct ids sorted by ascending random
    distance, the last ``n_pad`` slots -1 / INF."""
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.choice(n, size=E, replace=False) for _ in range(B)]).astype(np.int32)
    dists = np.sort(rng.uniform(0.1, 2.0, size=(B, E)).astype(np.float32), axis=1)
    ids[:, E - n_pad :] = -1
    dists[:, E - n_pad :] = np.float32(3.4e38)
    return ids, dists


@pytest.mark.parametrize("pool", [0, 20])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_select_from_search_dense(metric, pool):
    X, _ = _data(n=200, nq=1)
    ids, dists = _candidates(200, 12, 40, seed=7)
    want = jg.batch_select_from_search(jnp.asarray(X), jnp.asarray(ids), jnp.asarray(dists), M=8, metric=metric, pool=pool)
    got = tg.batch_select_from_search(_t(X), _t(ids, np.int64), _t(dists), M=8, metric=metric, pool=pool)
    _equal(got[0], want[0])
    _close(got[1], want[1])


def test_select_neighbors_on_a_cross_matrix():
    ids, dists = _candidates(100, 9, 30, seed=8)
    cross = np.random.default_rng(9).uniform(0.0, 2.0, size=(9, 30, 30)).astype(np.float32)
    for M in (4, 40):  # M wider than the candidate list too
        want = jg.batch_select_neighbors(jnp.asarray(ids), jnp.asarray(dists), jnp.asarray(cross), M=M)
        got = tg.batch_select_neighbors(_t(ids, np.int64), _t(dists), _t(cross), M=M)
        _equal(got[0], want[0])
        _close(got[1], want[1])


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_select_sparse_lazy(metric):
    """The lazy sparse selection (one K1 call per candidate, against the
    selected rows) against the JAX package's, and against the full cross
    matrix (the selection it replaced); the JAX pool path rides along."""
    X = _sparse(300, 2000, 20, seed=10)
    fj, ft = _feats(X, True)
    ids, dists = _candidates(300, 6, 48, seed=11)
    want = jg._select_sparse_lazy(fj, jnp.asarray(ids), jnp.asarray(dists), M=8, metric=metric)
    got = tg._select_sparse_lazy(ft, _t(ids, np.int64), _t(dists), M=8, metric=metric)
    _equal(got[0], want[0])
    _close(got[1], want[1])
    want_pool = jg.batch_select_from_search(fj, jnp.asarray(ids), jnp.asarray(dists), M=8, metric=metric, pool=24)
    got_pool = tg.batch_select_from_search(ft, _t(ids, np.int64), _t(dists), M=8, metric=metric, pool=24)
    _equal(got_pool[0], want_pool[0])


def test_select_with_sketch():
    from pecos_tpu.ann.hnsw.model import _hash_sketch as jax_sketch
    from pecos_tpu_torch.ann.hnsw.model import _hash_sketch

    X = _sparse(300, 5000, 20, seed=12)
    sk = _hash_sketch(X, 64)
    np.testing.assert_array_equal(sk, jax_sketch(X, 64))
    fj, ft = _feats(X, True)
    ids, dists = _candidates(300, 6, 40, seed=13)
    for metric in ("ip", "l2"):
        want = jg.batch_select_from_search(fj, jnp.asarray(ids), jnp.asarray(dists), M=8, metric=metric, sketch=jnp.asarray(sk))
        got = tg.batch_select_from_search(ft, _t(ids, np.int64), _t(dists), M=8, metric=metric, sketch=_t(sk))
        _equal(got[0], want[0])


def _adjacency(N, cap, seed, fill=0.6):
    """A random -1 padded adjacency and its distance co-array (INF at pads)."""
    rng = np.random.default_rng(seed)
    nbrs = rng.integers(0, N, size=(N, cap)).astype(np.int32)
    nbrs[rng.uniform(size=(N, cap)) > fill] = -1
    d = np.where(nbrs >= 0, rng.uniform(0.1, 2.0, size=(N, cap)), 3.4e38).astype(np.float32)
    return nbrs, d


def test_refine_union_candidates():
    N, cap, B, E = 150, 12, 10, 20
    nbrs, nd = _adjacency(N, cap, seed=14)
    nodes = np.arange(30, 30 + B, dtype=np.int32)
    nodes[-2:] = -2  # batch pads
    ids, dists = _candidates(N, B, E, seed=15)
    ids[:, 3] = np.where(nodes >= 0, nodes, ids[:, 3])  # the node finds itself
    ids[:4, 5] = nbrs[nodes[:4], 0]  # and some of its current neighbors
    want = jg.refine_union_candidates(*map(jnp.asarray, (nbrs, nd, nodes, ids, dists)))
    got = tg.refine_union_candidates(_t(nbrs), _t(nd), _t(nodes), _t(ids, np.int64), _t(dists))
    _equal(got[0], want[0])
    _close(got[1], want[1])


def test_scatter_set_rows_d_drops_pad_rows():
    N, cap = 40, 8
    nbrs, nd = _adjacency(N, cap, seed=16)
    rows = np.array([3, 17, N, 39, N + 5], np.int64)  # pads >= N are dropped, not wrapped
    ids = np.random.default_rng(17).integers(-1, N, size=(5, 5)).astype(np.int32)
    d = np.random.default_rng(18).uniform(size=(5, 5)).astype(np.float32)
    want = jg.scatter_set_rows_d(*map(jnp.asarray, (nbrs, nd, rows, ids, d)))
    tn, td = _t(nbrs), _t(nd)
    got = tg.scatter_set_rows_d(tn, td, _t(rows), _t(ids, np.int64), _t(d))
    assert got[0] is tn and tn.dtype == torch.int32  # in place, stored int32
    _equal(tn, want[0])
    _equal(td, want[1])


def _forward_edges(N, B, M, seed):
    """One batch's forward selections src -> dst with their distances; every
    third dst repeats so several edges meet at one node."""
    rng = np.random.default_rng(seed)
    sel = rng.integers(0, N // 3, size=(B, M)).astype(np.int32)
    sel[rng.uniform(size=(B, M)) > 0.8] = -1
    d = np.where(sel >= 0, rng.uniform(0.1, 2.0, size=(B, M)), 3.4e38).astype(np.float32)
    return sel, d


def test_reverse_merge_closest():
    N, cap, B, M = 120, 6, 16, 5
    nbrs, nd = _adjacency(N, cap, seed=19)
    sel, sd = _forward_edges(N, B, M, seed=20)
    src = np.arange(60, 60 + B, dtype=np.int64)
    src[-3:] = N  # pads
    want = jg.reverse_merge_closest(*map(jnp.asarray, (nbrs, nd, src, sel, sd)))
    got = tg.reverse_merge_closest(_t(nbrs), _t(nd), _t(src), _t(sel, np.int64), _t(sd))
    _equal(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("s0", [0, 32, 50])
def test_reverse_merge_chunk(s0):
    """Rows [s0, s0+B) of the refine pass's forward table; a start past the
    end is clamped as ``lax.dynamic_slice`` clamps it."""
    N, cap, B, M = 64, 6, 16, 4
    nbrs, nd = _adjacency(N, cap, seed=21)
    new_ids, new_d = _forward_edges(N, N, M, seed=22)
    want = jg.reverse_merge_chunk(*map(jnp.asarray, (nbrs, nd, new_ids, new_d)), jnp.int32(s0), B=B)
    got = tg.reverse_merge_chunk(_t(nbrs), _t(nd), _t(new_ids), _t(new_d), s0, B=B)
    _equal(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_exact_rescore(sparse):
    X, Q = _data(n=90, nq=8)
    if sparse:
        X, Q = smat.csr_matrix(X), smat.csr_matrix(Q)
    fj, ft = _feats(X, sparse)
    qj, qt = _queries(Q, sparse)
    ids = np.random.default_rng(23).permutation(90)[:40].reshape(8, 5).astype(np.int32)
    ids[:, -1] = -1
    for metric in ("ip", "l2"):
        want = jg.exact_rescore(qj, fj, jnp.asarray(ids), metric=metric)
        got = tg.exact_rescore(qt, ft, _t(ids, np.int64), metric=metric)
        _equal(got[0], want[0])
        _close(torch.where(got[0] >= 0, got[1], 0.0), np.where(np.asarray(want[0]) >= 0, want[1], 0.0))


def test_pack_neighbor_codes():
    nbrs, _ = _adjacency(50, 6, seed=24)
    codes = np.random.default_rng(25).integers(0, 16, size=(50, 4)).astype(np.uint8)
    want = jg.pack_neighbor_codes(jnp.asarray(nbrs), jnp.asarray(codes))
    got = tg.pack_neighbor_codes(_t(nbrs), _t(codes), chunk=16)
    _equal(got, want)
