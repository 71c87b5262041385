"""The port's balanced clustering, label embeddings and ClusterChain against
the JAX package's on the same numpy inputs (CPU).

``jax.random`` and torch's generators draw different numbers, so the level
split is compared on the JAX package's own draws, fed through the port's
``_level_split``: equal codes on well-separated data.  On random data two
labels whose scores tie to float rounding may swap ranks across a median
(the packages sum the dot products in another order), so at least 99% of the
codes must agree.  Whole trees built from each package's own draws are held
at the property level: balance within 1 per node, and chains of equal shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as smat
import torch

from pecos_tpu.utils.cluster_util import ClusterChain as JaxChain
from pecos_tpu.xmc import HierarchicalKMeans as JaxHKM
from pecos_tpu.xmc import LabelEmbeddingFactory as JaxLEF
from pecos_tpu.xmc import clustering as jclu
from pecos_tpu_torch.utils.cluster_util import ClusterChain
from pecos_tpu_torch.xmc import HierarchicalKMeans, Indexer, LabelEmbeddingFactory
from pecos_tpu_torch.xmc import clustering


def _unit_rows(L, D, seed):
    X = np.random.default_rng(seed).standard_normal((L, D)).astype(np.float32)
    return X / np.linalg.norm(X, axis=1, keepdims=True)


def _blobs(n_blobs, per_blob, D, seed, spread=0.05):
    """n_blobs well-separated communities of per_blob labels, unit rows."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_blobs, D)).astype(np.float32) * 4
    X = np.repeat(centers, per_blob, axis=0) + spread * rng.standard_normal((n_blobs * per_blob, D)).astype(np.float32)
    return X / np.linalg.norm(X, axis=1, keepdims=True)


@pytest.mark.parametrize("block", [None, 64])
def test_segment_sum_matches_index_add(block, monkeypatch):
    """The centers' deterministic sum (a stable sort by target, float64
    prefix sums) against float64 index_add_ rounded to float32: equal up to
    float64 rounding, one problem or a batch of them, in one column block and
    one scan chunk or in several; empty targets sum to 0."""
    from pecos_tpu_torch.utils import torch_util

    if block is not None:
        monkeypatch.setattr(torch_util, "_SEGMENT_SUM_BLOCK", block)
        monkeypatch.setattr(torch_util, "_SCAN_CHUNK", 8)
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, 12, size=(3, 40)))
    src = torch.from_numpy(rng.standard_normal((3, 40, 5)).astype(np.float32))
    want = torch.stack([torch.zeros(13, 5, dtype=torch.float64).index_add_(0, i, s.double()) for i, s in zip(idx, src)])
    got = torch_util.segment_sum(idx, src, 13)
    assert got.dtype == torch.float32 and got.shape == (3, 13, 5)
    np.testing.assert_allclose(got.numpy(), want.float().numpy(), rtol=1e-6, atol=1e-6)
    assert float(got[:, 12].abs().max()) == 0.0  # target 12 is never hit
    np.testing.assert_array_equal(torch_util.segment_sum(idx[1], src[1], 13).numpy(), got[1].numpy())


def _codes_both(feats, depth, seed, n_iter=10, rate=1.0, ratio=0.0, spherical=True):
    """Leaf codes of JAX's _level_split and of the port's fed JAX's draws,
    level by level (each package continues from its own codes)."""
    L, D = feats.shape
    n_nodes = 2 ** max(depth - 1, 0)
    key = jax.random.PRNGKey(seed)
    j_codes = jnp.zeros((L,), jnp.int32)
    t_codes = torch.zeros(L, dtype=torch.int64)
    feats_t = torch.from_numpy(feats)
    for _ in range(depth):
        key, sub = jax.random.split(key)
        k_init, k_sample = jax.random.split(sub)
        dirs = np.array(jax.random.normal(k_init, (n_nodes, D), dtype=jnp.float32))
        w_sample = np.array(jnp.where(jax.random.uniform(k_sample, (L,)) < rate, 1.0, 0.0), np.float32)
        j_codes = jclu._level_split(
            jnp.asarray(feats), j_codes, sub, jnp.float32(rate), jnp.float32(ratio),
            n_nodes_max=n_nodes, n_iter=n_iter, spherical=spherical,
        )
        t_codes = clustering._level_split(
            feats_t, t_codes, torch.from_numpy(dirs), torch.from_numpy(w_sample), ratio,
            n_nodes=n_nodes, n_iter=n_iter, spherical=spherical,
        )
    return np.asarray(j_codes), t_codes.numpy()


@pytest.mark.parametrize("spherical", [True, False])
def test_level_split_on_jax_draws_separated(spherical):
    feats = _blobs(8, 12, 16, seed=0)
    j, t = _codes_both(feats, depth=3, seed=5, spherical=spherical)
    np.testing.assert_array_equal(t, j)


def test_level_split_on_jax_draws_random():
    feats = _unit_rows(300, 24, seed=1)
    j, t = _codes_both(feats, depth=4, seed=2, rate=0.7)
    assert (t == j).mean() >= 0.99, (t == j).mean()


def test_level_split_imbalanced_on_jax_draws():
    """imbalanced_ratio > 0: a 24/40 two-community mix splits at the gap,
    24/40, in both packages; nested blobs split off-median at every level."""
    rng = np.random.default_rng(7)
    a, b = rng.standard_normal(12).astype(np.float32), rng.standard_normal(12).astype(np.float32)
    feats = np.vstack([a + 0.05 * rng.standard_normal((24, 12)), b + 0.05 * rng.standard_normal((40, 12))]).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    j, t = _codes_both(feats, depth=1, seed=0, ratio=0.3)
    np.testing.assert_array_equal(t, j)
    assert sorted(np.bincount(t, minlength=2).tolist()) == [24, 40]
    feats = np.vstack([_blobs(2, n, 10, seed=s) for s, n in ((3, 10), (4, 14))])
    j, t = _codes_both(feats, depth=2, seed=1, ratio=0.25)
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("L,depth,ratio", [(100, 3, 0.0), (37, 4, 0.0), (64, 2, 0.3)])
def test_hierarchical_balanced_kmeans_balance(L, depth, ratio):
    """Strict balance (sizes within 1 at every level) without a ratio; with
    one, every split stays inside the ±ratio window."""
    codes = clustering.hierarchical_balanced_kmeans(
        _unit_rows(L, 8, seed=L), depth, max_iter=5, seed=1, imbalanced_ratio=ratio, device="cpu"
    )
    assert codes.shape == (L,) and codes.min() >= 0 and codes.max() < 2**depth
    for d in range(1, depth + 1):
        counts = np.bincount(codes >> (depth - d), minlength=2**d)
        if ratio == 0:
            assert counts.max() - counts.min() <= 1, f"imbalance at level {d}: {counts}"
        else:
            parent = counts.reshape(-1, 2).sum(axis=1)
            assert (np.abs(counts.reshape(-1, 2)[:, 1] - parent / 2) <= ratio * parent + 1).all()
    again = clustering.hierarchical_balanced_kmeans(
        _unit_rows(L, 8, seed=L), depth, max_iter=5, seed=1, imbalanced_ratio=ratio, device="cpu"
    )
    np.testing.assert_array_equal(again, codes)  # seeded: the same tree twice


def test_random_project_bit_equal():
    rng = np.random.default_rng(3)
    A = smat.random(40, 300, density=0.05, random_state=rng, format="csr", dtype=np.float32)
    for feat in (A, A.toarray()):
        np.testing.assert_array_equal(
            clustering.random_project(feat, 16, seed=4, block=128), jclu.random_project(feat, 16, seed=4, block=128)
        )


def test_pifa_pii_match_jax():
    rng = np.random.default_rng(0)
    X = smat.random(50, 20, density=0.3, random_state=rng, format="csr", dtype=np.float32)
    Y = smat.random(50, 12, density=0.2, random_state=rng, format="csr", dtype=np.float32)
    for method in ("pifa", "pii"):
        got = LabelEmbeddingFactory.create(Y, X, method=method)
        want = JaxLEF.create(Y, X, method=method)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.toarray(), want.toarray(), rtol=1e-6, atol=1e-6)
    Z = rng.standard_normal((12, 20)).astype(np.float32)
    for method in ("pifa_lf_concat", "pifa_lf_convex_combine"):
        got, want = LabelEmbeddingFactory.create(Y, X, Z, method=method), JaxLEF.create(Y, X, Z, method=method)
        dense = lambda a: a.toarray() if smat.issparse(a) else np.asarray(a)
        np.testing.assert_allclose(dense(got), dense(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("L,leaf,splits,extra", [(260, 10, 4, {}), (100, 4, 5, {}), (7, 100, 16, {}), (64, 16, 2, dict(max_cluster_feature_dim=8, proj_dim=6))])
def test_gen_chain_shapes_match_jax(L, leaf, splits, extra):
    feats = _unit_rows(L, 12, seed=2)
    got = Indexer.gen(feats, max_leaf_size=leaf, nr_splits=splits, device="cpu", **extra)
    want = JaxHKM.gen(feats, max_leaf_size=leaf, nr_splits=splits, **extra)
    assert [C.shape for C in got] == [C.shape for C in want]
    for C in got:  # every node has exactly one parent
        assert (np.diff(C.tocsr().indptr) == 1).all()
    with pytest.raises(ValueError, match="nr_splits"):
        HierarchicalKMeans.gen(feats, nr_splits=1, device="cpu")


def test_cluster_chain_folders_both_ways(tmp_path):
    """A chain saved by either package loads in the other, equal; derived
    chains (matching, relevance, children tables) agree too."""
    jchain = JaxHKM.gen(_unit_rows(60, 8, seed=3), max_leaf_size=4, nr_splits=4)
    jchain.save(str(tmp_path / "jax"))
    port = ClusterChain.load(str(tmp_path / "jax"))
    assert [C.shape for C in port] == [C.shape for C in jchain]
    assert all((a != b).nnz == 0 for a, b in zip(port, jchain))
    port.save(str(tmp_path / "port"))
    back = JaxChain.load(str(tmp_path / "port"))
    assert back == jchain and ClusterChain.load(str(tmp_path / "port")) == port

    rng = np.random.default_rng(4)
    M0 = smat.random(30, 60, density=0.05, random_state=rng, format="csr", dtype=np.float32)
    M2 = smat.random(30, port[-2].shape[1], density=0.2, random_state=rng, format="csr", dtype=np.float32)
    for got, want in zip(port.generate_matching_chain({0: M0, 2: M2}), jchain.generate_matching_chain({0: M0, 2: M2})):
        assert got.shape == want.shape and abs(got - want).max() == 0
    for norm in ("no-norm", "l1", "l2", "max"):
        for induce in (True, False):
            got = port.generate_relevance_chain({0: M0}, norm_type=norm, induce=induce)
            want = jchain.generate_relevance_chain({0: M0}, norm_type=norm, induce=induce)
            for g, w in zip(got, want):
                assert (g is None) == (w is None)
                if g is not None:
                    np.testing.assert_allclose(g.toarray(), w.toarray(), rtol=1e-6)
    for d in range(len(port)):
        np.testing.assert_array_equal(port.padded_children(d)[0], jchain.padded_children(d)[0])
        np.testing.assert_array_equal(port.parents_of(d), jchain.parents_of(d))
    partial = ClusterChain.from_partial_chain(port[-1], min_codes=2, nr_splits=3)
    assert [C.shape for C in partial] == [C.shape for C in JaxChain.from_partial_chain(jchain[-1], min_codes=2, nr_splits=3)]
