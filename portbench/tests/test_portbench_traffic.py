"""The generator: determinism by seed, the same work for every seed, topics
that spread the beams, TF-IDF values, and the published shapes of the two
datasets' trees."""

import json
import os

import numpy as np
import pytest
import torch

from portbench import traffic
from portbench.models import xrlinear

CPU = torch.device("cpu")
BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAW = {"law": "lognormal", "sigma": 0.8, "min": 1, "max": 4096}


TOPIC = {"features": 8, "node_slots": 8, "label_slots": 4, "query_share": 0.25, "weight_mean": 0.5, "weight_std": 0.25}
SMALL = dict(nr_labels=1500, nr_features=3000, nr_splits=4, max_leaf_size=20, weights_per_label=16, bias=1.0,
             zipf_s=1.0, weight_std=0.25, bias_weight_std=0.05, mean_query_nnz=40, topic=TOPIC)


def model(seed, **over):
    return xrlinear.Model(dict(SMALL, **over), seed, CPU)


def pool(seed, n=600, m=None):
    m = m or model(seed)
    lengths = traffic.permuted(traffic.quantile_lengths(n, LAW, m.mean_nnz), seed, "order")
    return traffic.query_pool(n, lengths, m, seed, CPU)


def test_same_seed_same_inputs_and_large_seeds():
    seed = 2**32 + 17  # more than 32 signed bits
    a, b = pool(seed), pool(seed)
    assert (a != b).nnz == 0 and np.array_equal(a.indptr, b.indptr)
    c = pool(seed + 1)
    assert (a != c).nnz > 0


def test_every_seed_asks_for_the_same_lengths_in_another_order():
    a, b = pool(5), pool(6)
    la, lb = np.diff(a.indptr), np.diff(b.indptr)
    assert not np.array_equal(la, lb)
    assert np.array_equal(np.sort(la), np.sort(lb))


def test_rows_distinct_sorted_unit_norm_positive():
    X = pool(7)
    for r in range(X.shape[0]):
        ids = X.indices[X.indptr[r] : X.indptr[r + 1]]
        assert len(np.unique(ids)) == len(ids) and np.all(np.diff(ids) > 0)
    assert np.all(X.data > 0)
    np.testing.assert_allclose(np.sqrt(X.multiply(X).sum(axis=1)).A1, 1.0, rtol=1e-5)


def test_popularity_is_zipf_over_a_permutation():
    D = 1000
    pop = traffic.Popularity(D, 1.0, traffic.generator(3, "weights", CPU), CPU)
    r = pop.ranks(200_000, traffic.generator(3, "queries", CPU)).numpy()
    freq = np.bincount(r, minlength=D)
    # P(rank 0) / P(rank 9) = 10 under Zipf(1)
    assert 8 < freq[0] / freq[9] < 12
    assert sorted(pop.perm.tolist()) == list(range(D))


def test_quantile_lengths_mean_and_clip():
    n = 65536
    wiki = traffic.quantile_lengths(n, LAW, 387)
    assert wiki.min() >= 1 and wiki.max() <= 4096
    assert abs(wiki.mean() - 387) / 387 < 0.01
    uni = traffic.quantile_lengths(1000, {"law": "uniform", "min": 4, "max": 32}, 0)
    assert uni.min() == 4 and uni.max() == 32 and set(np.unique(uni)) == set(range(4, 33))


def test_arrivals_fill_the_window_in_order():
    t = traffic.arrival_times(2000, 10.0, 9)
    assert t[0] == 0 and np.all(np.diff(t) >= 0) and t[-1] < 10.0
    gaps = np.diff(t)
    assert 0.68 < np.median(gaps) / np.mean(gaps) < 0.71  # ln 2 for exponential gaps
    u = traffic.arrival_times(2000, 10.0, 10)
    assert not np.array_equal(t, u)
    # the same gaps in another order, but the last (dropped by the window) differ
    assert abs(np.sort(np.diff(t))[1000] - np.sort(np.diff(u))[1000]) < 1e-3


def test_query_values_are_tfidf():
    """Within a row, value / idf is 0.5 + U[0, 1) times one scale: the rare
    features weigh more than the popular ones."""
    m = model(8)
    X = pool(8, m=m)
    idf = m.popularity.idf(torch.as_tensor(X.indices.astype(np.int64)), m.mean_nnz).numpy()
    ratio = X.data / idf
    for r in range(50):
        a, b = X.indptr[r], X.indptr[r + 1]
        if b - a > 1:
            assert ratio[a:b].max() / ratio[a:b].min() < 3.0 + 1e-6
    ranks = m.popularity.rank_of[torch.as_tensor(X.indices.astype(np.int64))].numpy()
    assert np.median(X.data[ranks < 10]) < np.median(X.data[ranks > 1000])


def test_queries_draw_a_quarter_from_their_path_and_weights_weigh_their_group():
    m = model(9)
    X = pool(9, n=400, m=m)
    group_of = np.full(m.D, -1)
    ids = m.topics.ids.numpy()
    group_of[ids.ravel()] = np.repeat(np.arange(ids.shape[0]), ids.shape[1])
    paths = {tuple(p) for p in m.paths.numpy().tolist()}
    for r in range(X.shape[0]):
        row = X.indices[X.indptr[r] : X.indptr[r + 1]]
        groups = group_of[row]
        T, k = m.paths.shape[1], round(0.25 * len(row))
        want = sum(min(k // T + (level >= T - k % T), TOPIC["features"]) for level in range(T))
        # the groups of one path hold at least the drawn count (a popular draw can land in a group too)
        on_path = [p for p in paths if np.sum(np.isin(groups, p)) >= want]
        assert on_path, r
    # a node weighs its own group's features positively, on average
    inner = sum(m.sizes[:-1])
    first = np.cumsum([0] + m.sizes)
    for d in range(m.depth - 1):
        for node in range(0, m.sizes[d], max(1, m.sizes[d] // 5)):
            own = np.isin(m.ids[d][node, :-1], ids[first[d] + node])
            assert own.sum() == TOPIC["node_slots"]
            assert m.vals[d][node, :-1][own].mean() > m.vals[d][node, :-1][~own].mean()
    assert inner == ids.shape[0]


def test_beams_spread_as_widely_as_uniform_ones():
    """The queries of a batch reach nearly as many leaf clusters as beams of
    uniformly drawn clusters would; without topics they crowd into a few."""
    from portbench.models import xrlinear_reference, xrlinear_work

    def spread(share):
        m = model(10, topic=dict(TOPIC, query_share=share))
        X = pool(10, n=256, m=m)
        ref = xrlinear_reference.Reference(m.ids, m.vals, m.parents, m.D, m.bias, 4, 8, "l3-hinge", CPU)
        beam = ref.beam_search(X, keep_beams=True)["beams"][-1]
        return xrlinear_work.leaf_spread(beam, m.sizes[-2])

    topical, flat = spread(0.25), spread(0.0)
    assert topical["distinct"] > 0.7 * topical["uniform"]
    assert flat["distinct"] < 0.5 * topical["distinct"]


@pytest.mark.parametrize(
    "L, D, sizes, leaf",
    [
        (501070, 2381304, [2, 32, 512, 8192, 501070], (61, 62)),  # Wiki-500K
        (2812281, 337067, [8, 128, 2048, 32768, 2812281], (85, 86)),  # Amazon-3M
    ],
)
def test_published_trees(L, D, sizes, leaf):
    got = xrlinear.tree_sizes(L, 16, 100)
    assert got == sizes
    parents = xrlinear.tree_parents(got, 16, seed=1)
    counts = np.bincount(parents[-1], minlength=sizes[-2])
    assert (counts.min(), counts.max()) == leaf
    for d in range(1, len(sizes) - 1):
        assert np.bincount(parents[d]).max() <= 16
    again = xrlinear.tree_parents(got, 16, seed=1)
    assert np.array_equal(parents[-1], again[-1])
    # the port scores every level below the dense top one with K1
    from portbench.models import xrlinear_work

    assert xrlinear_work.k1_levels(D, got) == [False, True, True, True, True]


def test_wiki500k_configuration_is_the_published_shape():
    with open(os.path.join(BENCH_DIR, "configs", "xrlinear-wiki500k.json")) as f:
        cfg = json.load(f)
    assert (cfg["nr_labels"], cfg["nr_features"], cfg["mean_query_nnz"]) == (501070, 2381304, 387)
    assert xrlinear.tree_sizes(cfg["nr_labels"], cfg["nr_splits"], cfg["max_leaf_size"])[:-1] == [2, 32, 512, 8192]
    assert cfg["reduced"] == [] and set(cfg["assumed"]) >= {"weights_per_label", "topic", "query_values"}


def test_model_weights_distinct_with_bias_last():
    m = model(11)
    m2 = model(11)
    for d in range(m.depth):
        ids = m.ids[d]
        assert ids.shape == (m.sizes[d], 16) and np.all(ids[:, -1] == 3000)
        assert np.all(np.diff(ids, axis=1) > 0)
        assert np.array_equal(ids, m2.ids[d]) and np.array_equal(m.vals[d], m2.vals[d])
        W = m.csc(d)
        assert W.shape == (3001, m.sizes[d]) and W.nnz == 16 * m.sizes[d]
