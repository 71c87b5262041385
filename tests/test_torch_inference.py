"""Beam-search predict: the port's CompiledHierModel against the JAX package's.

Both sides predict over identical weights: the port's layers are built with
``layers_from_numpy`` from the JAX model's device layers.  Labels must be
equal (both break score ties towards the lower candidate index); scores agree
to rtol=1e-5 (float32 sums in another order: the dense-layer contraction and
the final P-sum of the intersection), with atol=1e-7, about one float32 ulp
of the path values' scale (~1), for path values that cancel towards zero.
"""

import numpy as np
import pytest
import scipy.sparse as smat
import torch

from pecos_tpu.xmc.inference import CompiledHierModel as JaxModel
from pecos_tpu_torch.xmc.inference import (
    CompiledHierModel,
    build_device_layer,
    layers_from_numpy,
    prepare_queries_padded,
    query_cap,
)

BEAM, TOPK = 3, 10


def _unique_rows(rng, n_rows, width, hi):
    base = np.sort(rng.integers(0, hi - width + 1, size=(n_rows, width)), axis=1)
    return base + np.arange(width)


def make_chain(D, sizes, nnz, feat_hi, seed):
    """(Ws, Cs): every label has ``nnz`` weights on features in [0, feat_hi)
    plus one on the bias feature D, so no two candidates tie on the bias alone."""
    rng = np.random.default_rng(seed)
    Ws, Cs, n_parents = [], [], 1
    for L in sizes:
        rows = np.concatenate([_unique_rows(rng, L, nnz, feat_hi), np.full((L, 1), D)], axis=1)
        vals = (rng.standard_normal(rows.shape) * 0.3).astype(np.float32)
        cols = np.repeat(np.arange(L), nnz + 1)
        Ws.append(smat.csc_matrix((vals.ravel(), (rows.ravel(), cols)), shape=(D + 1, L)))
        parent = np.arange(L) * n_parents // L
        Cs.append(smat.csc_matrix((np.ones(L, np.float32), (np.arange(L), parent)), shape=(L, n_parents)))
        n_parents = L
    return Ws, Cs


def make_queries(N, D, max_nnz, feat_hi, seed):
    """CSR queries with 1..max_nnz nonzeros per row, so rows are padded."""
    rng = np.random.default_rng(seed)
    nnz = rng.integers(1, max_nnz + 1, size=N)
    ids = [np.sort(rng.choice(feat_hi, size=k, replace=False)) for k in nnz]
    indptr = np.concatenate([[0], np.cumsum(nnz)])
    vals = rng.uniform(0.05, 0.5, size=int(nnz.sum())).astype(np.float32)
    return smat.csr_matrix((vals, np.concatenate(ids), indptr), shape=(N, D))


def jax_layer_arrays(jax_model):
    """The JAX model's device layers as numpy arrays, ``parent_packed`` included."""
    out = []
    for l in jax_model.layers:
        d = {"kind": l.kind, "nr_labels": l.nr_labels, "children": np.asarray(l.children)}
        if l.kind == "dense":
            d["W"] = np.asarray(l.W)
        else:
            d["packed"] = np.asarray(l.packed)
            d["parent_packed"] = np.asarray(l.parent_packed)
        out.append(d)
    return out


# name: (D, level sizes, layouts, nnz per label, feature range, queries, query nnz,
#        densified queries expected)
CASES = {
    # small D: sparse queries are densified on the device for the dense top layer
    "scatter": (128, [4, 32, 256], ["dense", "plabel", "plabel"], 6, 128, 200, 24, True),
    # 1024 x (D+2) > 2**26: the dense layer scores by a W-row gather instead
    "gather": (100_000, [4, 32, 256], ["dense", "plabel", "plabel"], 6, 512, 1024, 48, False),
    "all_dense": (128, [4, 32, 256], ["dense", "dense", "dense"], 6, 128, 200, 24, True),
}


def _models(case):
    D, sizes, layouts, nnz, feat_hi, N, q_nnz, _ = CASES[case]
    Ws, Cs = make_chain(D, sizes, nnz, feat_hi, seed=len(case))
    jm = JaxModel.from_host_chain(Ws, Cs, 1.0, layouts=layouts)
    tm = CompiledHierModel(layers_from_numpy(jax_layer_arrays(jm), "cpu"), 1.0, D)
    X = make_queries(N, D, q_nnz, feat_hi, seed=N)
    return jm, tm, X, (Ws, Cs, layouts)


def assert_same_predictions(P_jax, P_port):
    assert P_port.shape == P_jax.shape
    np.testing.assert_array_equal(P_port.indptr, P_jax.indptr)
    np.testing.assert_array_equal(P_port.indices, P_jax.indices)
    np.testing.assert_allclose(P_port.data, P_jax.data, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize(
    "case, pp",
    [
        ("scatter", "l3-hinge"),
        ("scatter", "sigmoid"),
        ("gather", "l3-hinge"),
        ("gather", "log-sigmoid"),
        ("all_dense", "l3-hinge"),
    ],
)
def test_sparse_predict_matches_jax(case, pp):
    jm, tm, X, _ = _models(case)
    N, q_nnz = CASES[case][5], CASES[case][6]
    cap = max(64, 1 << (q_nnz - 1).bit_length())
    assert tm.uses_dense_queries(N, cap) == CASES[case][7]
    P_port = tm.predict(X, beam_size=BEAM, only_topk=TOPK, post_processor=pp)
    assert P_port.nnz == N * TOPK
    assert_same_predictions(jm.predict(X, beam_size=BEAM, only_topk=TOPK, post_processor=pp), P_port)


def test_permuted_uneven_label_level_matches_jax():
    """A label level dealt to leaf clusters of uneven sizes by a seeded
    permutation, as the benchmark's tree deals it: the children table holds
    -1 pads and a cluster's labels are scattered packed rows.  The port takes
    the JAX package's layer arrays, ``parent_packed`` included, keeps the
    packed rows alone, and predicts as the JAX package does."""
    D, sizes, layouts, nnz, feat_hi, N, q_nnz, _ = CASES["scatter"]
    Ws, Cs = make_chain(D, sizes, nnz, feat_hi, seed=11)
    rng = np.random.default_rng(11)
    L, n_leaf = sizes[-1], sizes[-2]
    leaf = np.empty(L, np.int64)
    counts = rng.multinomial(L - n_leaf, np.full(n_leaf, 1.0 / n_leaf)) + 1  # a label at least a cluster
    leaf[rng.permutation(L)] = np.repeat(np.arange(n_leaf), counts)
    Cs[-1] = smat.csc_matrix((np.ones(L, np.float32), (np.arange(L), leaf)), shape=(L, n_leaf))
    jm = JaxModel.from_host_chain(Ws, Cs, 1.0, layouts=layouts)
    arrays = jax_layer_arrays(jm)
    assert "parent_packed" in arrays[-1] and (arrays[-1]["children"] < 0).any()
    tm = CompiledHierModel(layers_from_numpy(arrays, "cpu"), 1.0, D)
    for got, want in zip(tm.layers[1:], arrays[1:]):
        assert got.kind == "plabel" and got.W is None and not hasattr(got, "parent_packed")
        np.testing.assert_array_equal(got.packed.numpy(), want["packed"])
        assert got.nbytes == got.children.numel() * 8 + got.packed.numel() * 4
    X = make_queries(N, D, q_nnz, feat_hi, seed=N)
    for pp in ("l3-hinge", "sigmoid"):
        kw = dict(beam_size=BEAM, only_topk=TOPK, post_processor=pp)
        assert_same_predictions(jm.predict(X, **kw), tm.predict(X, **kw))


def test_dense_queries_match_jax():
    """Dense X: plabel layers gather x at their weight ids (no intersection)."""
    jm, tm, X, _ = _models("scatter")
    Xd = np.asarray(X.todense())
    assert_same_predictions(jm.predict(Xd, beam_size=BEAM, only_topk=TOPK), tm.predict(Xd, beam_size=BEAM, only_topk=TOPK))


def test_batches_and_ragged_tail_match_jax():
    """Several batches with a short last batch, per-layer post-processors."""
    jm, tm, X, _ = _models("scatter")
    pp = ("sigmoid", "l3-hinge", "log-l2-hinge")
    kw = dict(beam_size=BEAM, only_topk=TOPK, post_processor=pp, batch_size=64)
    assert_same_predictions(jm.predict(X, **kw), tm.predict(X, **kw))


@pytest.mark.parametrize("case", ["scatter", "gather"])
def test_build_device_layer_matches_jax(case):
    jm, _, _, (Ws, Cs, layouts) = _models(case)
    port = CompiledHierModel.from_host_chain(Ws, Cs, 1.0, layouts=layouts, device="cpu")
    assert port.nr_features == jm.nr_features
    for got, want in zip(port.layers, jax_layer_arrays(jm)):
        assert (got.kind, got.nr_labels) == (want["kind"], want["nr_labels"])
        np.testing.assert_array_equal(got.children.numpy(), want["children"])
        for name in ("W", "packed"):
            if name in want:
                np.testing.assert_array_equal(getattr(got, name).numpy(), want[name])
    # default layouts follow the same size rule
    auto = build_device_layer(Ws[2], Cs[2], device="cpu")
    assert auto.kind == ("plabel" if (Ws[2].shape[0] * Ws[2].shape[1]) > (1 << 24) else "dense")


@pytest.mark.parametrize("row_nnz, cap", [([], 64), ([0, 0], 64), ([3, 64], 64), ([65, 1], 128), ([1000], 1024)])
def test_query_cap(row_nnz, cap):
    """The padded width: the longest row rounded up to a power of two, at least 64."""
    indptr = np.concatenate([[0], np.cumsum(row_nnz, dtype=np.int64)]).astype(np.int64)
    n = int(indptr[-1])
    A = smat.csr_matrix((np.ones(n, np.float32), np.arange(n) % 2000, indptr), shape=(len(row_nnz), 2000))
    assert query_cap(A) == cap
    assert prepare_queries_padded(A)[0].shape == (len(row_nnz), cap)


def test_prepare_queries_padded_pads_with_d_plus_one():
    X = make_queries(10, 50, 7, 50, seed=3)
    ids, vals = prepare_queries_padded(X, cap=8)
    assert ids.dtype == np.int32 and vals.dtype == np.float32 and ids.shape == (10, 8)
    nnz = np.diff(X.indptr)
    pad = np.arange(8)[None, :] >= nnz[:, None]
    assert (ids[pad] == 51).all() and (vals[pad] == 0).all()
    np.testing.assert_array_equal(ids[~pad], X.indices)


def test_predict_input_errors():
    _, tm, X, _ = _models("scatter")
    with pytest.raises(ValueError, match="unknown wire_value_dtype"):
        tm.predict(X, wire_value_dtype="float64")
    with pytest.raises(ValueError, match="Feature dimension"):
        tm.predict(X[:, :-1])
    with pytest.raises(ValueError, match="unknown post_processor"):
        tm.predict(X, post_processor="nope")
    P = tm.predict(X[:0])
    assert P.shape == (0, tm.nr_labels) and P.nnz == 0
    assert tm.layers[0].to("cpu").W.device == torch.device("cpu")
