"""The plain reference against brute force on tiny trees."""

import itertools

import numpy as np
import scipy.sparse as smat
import torch

from portbench import traffic
from portbench.models import xrlinear, xrlinear_reference

CPU = torch.device("cpu")
CFG = dict(nr_labels=120, nr_features=300, nr_splits=3, max_leaf_size=10, weights_per_label=12,
           bias=1.0, zipf_s=1.0, weight_std=0.25, bias_weight_std=0.05, mean_query_nnz=30,
           topic=dict(features=4, node_slots=4, label_slots=2, query_share=0.25, weight_mean=0.5, weight_std=0.25))


def tiny(seed=3, n=40):
    m = xrlinear.Model(CFG, seed, CPU)
    lengths = traffic.quantile_lengths(n, {"law": "uniform", "min": 1, "max": 60}, 0)
    X = traffic.query_pool(n, lengths, m, seed, CPU)
    return m, X


def reference(m, beam, topk):
    return xrlinear_reference.Reference(m.ids, m.vals, m.parents, m.D, m.bias, beam, topk, "l3-hinge", CPU)


def brute_values(m, X):
    """(n, L) float64: every label's path value, by dense products."""
    Xb = np.hstack([X.toarray().astype(np.float64), np.full((X.shape[0], 1), m.bias)])
    val = np.ones((X.shape[0], m.sizes[-1]))
    node = np.arange(m.sizes[-1])
    for d in range(m.depth - 1, -1, -1):
        score = Xb @ m.csc(d).toarray().astype(np.float64)
        val *= np.exp(-np.maximum(1 - score[:, node], 0) ** 3)
        node = m.parents[d][node]
    return val


def test_full_beam_is_exhaustive_top_k():
    m, X = tiny()
    widest = max(m.sizes)
    out = reference(m, beam=widest, topk=7).beam_search(X)
    brute = brute_values(m, X)
    want = np.argsort(-brute, axis=1, kind="stable")[:, :7]
    assert np.array_equal(out["labels"], want)
    np.testing.assert_allclose(out["values"], np.take_along_axis(brute, want, 1), rtol=1e-12)


def test_path_values_are_brute_force_values():
    m, X = tiny(seed=4)
    labels = np.tile(np.arange(-1, 9), (X.shape[0], 1))
    got = reference(m, 2, 5).path_values(X, labels)
    brute = brute_values(m, X)
    assert np.all(np.isnan(got[:, 0]))
    np.testing.assert_allclose(got[:, 1:], brute[:, :9], rtol=1e-12)


def loop_beam(m, X, beam, topk):
    """The beam search written out query by query, in plain Python."""
    brute_scores = []
    Xb = np.hstack([X.toarray().astype(np.float64), np.full((X.shape[0], 1), m.bias)])
    for d in range(m.depth):
        brute_scores.append(Xb @ m.csc(d).toarray().astype(np.float64))
    kids = [xrlinear_reference.children_of(m.parents[d], 1 if d == 0 else m.sizes[d - 1]) for d in range(m.depth)]
    out = []
    for q in range(X.shape[0]):
        beam_nodes, beam_vals = [0], [1.0]
        for d in range(m.depth):
            cands = [(pv * np.exp(-max(1 - brute_scores[d][q, c], 0) ** 3), c)
                     for p, pv in zip(beam_nodes, beam_vals) for c in kids[d][p] if c >= 0]
            order = sorted(range(len(cands)), key=lambda i: (-cands[i][0], i))
            k = topk if d == m.depth - 1 else beam
            beam_vals = [cands[i][0] for i in order[:k]]
            beam_nodes = [cands[i][1] for i in order[:k]]
        out.append(beam_nodes)
    return np.array(out)


def test_narrow_beam_matches_the_loop():
    m, X = tiny(seed=5)
    out = reference(m, beam=2, topk=4).beam_search(X)
    assert np.array_equal(out["labels"], loop_beam(m, X, 2, 4))
    assert np.all(out["margin"] >= 0)


def test_margin_flags_ties():
    m, X = tiny(seed=6, n=4)
    # queries with no features: every score is the bias alone, and siblings
    # with equal bias weights tie exactly
    for d in range(m.depth):
        m.vals[d][:, -1] = 0.01
    Z = smat.csr_matrix((4, m.D), dtype=np.float32)
    out = reference(m, beam=2, topk=3).beam_search(Z)
    assert np.all(out["margin"] == 0)
