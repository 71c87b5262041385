"""Sparse query batches padded on the device: ``pad_csr_on_device`` over
``csr_rows``'s slice equals the host's ``pad_query_rows(prepare_queries_padded)``
bit for bit, and ``CompiledHierModel.predict``, which pads float32-wire batches
on the device, answers as the host-padded path does, on every wire and for
dense X."""

import numpy as np
import pytest
import scipy.sparse as smat
import torch

from pecos_tpu_torch.utils import profile_util
from pecos_tpu_torch.xmc.inference import (
    CompiledHierModel,
    _fetch_topk,
    _pp_names,
    chain_predict,
    csr_rows,
    decode_wire_batch,
    encode_wire_batch,
    pad_csr_on_device,
    pad_query_rows,
    prepare_queries,
    prepare_queries_padded,
)

WIRES = ["float32", "float16", "bfloat16", "uint8"]


def csr(rows, D, dtype=np.float32, seed=0):
    """CSR of the given rows (lists of ids, in the order given), values drawn
    from the seed, with indices and data exactly as passed (no sort, no sum)."""
    rng = np.random.default_rng(seed)
    indptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])]).astype(np.int32)
    indices = np.concatenate([np.asarray(r, np.int64) for r in rows] or [np.zeros(0, np.int64)])
    data = rng.standard_normal(indices.size).astype(dtype)
    A = smat.csr_matrix((data, indices, indptr), shape=(len(rows), D))
    A.indices, A.indptr, A.data = indices.astype(A.indices.dtype), indptr.astype(A.indptr.dtype), data
    return A


def random_rows(rng, N, D, lo, hi):
    return [np.sort(rng.choice(D, size=rng.integers(lo, hi + 1), replace=False)) for _ in range(N)]


def case(name):
    rng = np.random.default_rng(7)
    D = 1000
    if name == "empty_rows":
        rows = random_rows(rng, 40, D, 0, 30)
        for r in (0, 5, 6, 39):
            rows[r] = []
        return csr(rows, D), 64, 64
    if name == "short_last_batch":
        return csr(random_rows(rng, 70, D, 1, 40), D), 32, 64
    if name == "row_of_exactly_cap":
        rows = random_rows(rng, 20, D, 1, 40)
        rows[3] = np.sort(rng.choice(D, size=64, replace=False))
        return csr(rows, D), 32, 64
    if name == "every_row_full":
        return csr(random_rows(rng, 16, D, 64, 64), D), 16, 64
    if name == "unsorted_indices":
        return csr([rng.permutation(r) for r in random_rows(rng, 30, D, 2, 50)], D), 32, 64
    if name == "explicit_zeros":
        A = csr(random_rows(rng, 30, D, 1, 50), D)
        A.data[::3] = 0.0
        assert A.nnz == A.indptr[-1] and (A.data == 0).any()
        return A, 32, 64
    if name == "duplicate_ids":
        rows = random_rows(rng, 30, D, 1, 30)
        rows = [np.concatenate([r, r[: len(r) // 2]]) for r in rows]
        return csr(rows, D), 32, 64
    if name == "float64_data":
        A = csr(random_rows(rng, 30, D, 1, 50), D, dtype=np.float64)
        A.data = A.data / 3.0  # values float32 cannot hold exactly
        return A, 32, 64
    if name == "int64_indices":
        A = csr(random_rows(rng, 30, D, 1, 50), D)
        A.indices, A.indptr = A.indices.astype(np.int64), A.indptr.astype(np.int64)
        return A, 32, 64
    if name == "one_row":
        return csr(random_rows(rng, 1, D, 5, 5), D), 1, 64
    if name == "d_near_2_31":
        D = 2**31 - 2
        rows = [np.sort(rng.choice(D, size=n, replace=False)) for n in rng.integers(1, 40, size=20)]
        rows[0][-1] = D - 1
        return csr(rows, D), 32, 64
    raise KeyError(name)


CASES = ["empty_rows", "short_last_batch", "row_of_exactly_cap", "every_row_full", "unsorted_indices",
         "explicit_zeros", "duplicate_ids", "float64_data", "int64_indices", "one_row", "d_near_2_31"]


@pytest.mark.parametrize("name", CASES)
def test_device_padding_equals_the_host_padding_bit_for_bit(name):
    A, batch, cap = case(name)
    N, D = A.shape
    for s in range(0, N, batch):
        e = min(s + batch, N)
        rows = csr_rows(A, s, e)
        assert [a.dtype for a in rows] == [np.int64, np.int32, np.float32]
        ids, vals = pad_csr_on_device(*(torch.from_numpy(a) for a in rows), batch, cap, D)
        ref_ids, ref_vals = pad_query_rows(*prepare_queries_padded(A[s:e], cap=cap), batch, D)
        assert ids.dtype == torch.int32 and vals.dtype == torch.float32
        np.testing.assert_array_equal(ids.numpy(), ref_ids)
        np.testing.assert_array_equal(vals.numpy().view(np.int32), ref_vals.view(np.int32))


D = 128
SIZES = [4, 32, 256]


def make_model(layouts):
    """A tree over SIZES on the CPU: every node weighs 6 features and the bias."""
    rng = np.random.default_rng(0)
    Ws, Cs, n_parents = [], [], 1
    for L in SIZES:
        rows = np.concatenate([np.sort(rng.choice(D, size=(L, 6)), axis=1), np.full((L, 1), D)], axis=1)
        vals = (rng.standard_normal(rows.shape) * 0.3).astype(np.float32)
        Ws.append(smat.csc_matrix((vals.ravel(), (rows.ravel(), np.repeat(np.arange(L), 7))), shape=(D + 1, L)))
        Cs.append(smat.csc_matrix((np.ones(L, np.float32), (np.arange(L), np.arange(L) * n_parents // L)),
                                  shape=(L, n_parents)))
        n_parents = L
    return CompiledHierModel.from_host_chain(Ws, Cs, 1.0, layouts=layouts, device="cpu")


@pytest.fixture(scope="module", params=[("dense", "plabel", "plabel"), ("plabel",) * 3], ids=["dense_top", "plabel"])
def model(request):
    return make_model(list(request.param))


@pytest.fixture
def X():
    X = smat.random(200, D, density=0.1, format="csr", random_state=1, dtype=np.float32)
    X = X.tolil()
    X[[0, 77, 199]] = 0  # empty rows
    return X.tocsr()


KW = dict(beam_size=4, only_topk=5, post_processor="l3-hinge")


def host_padded_predict(model, X, wire, batch):
    """Predict as the host pads every sparse batch, on ``wire``; dense X in
    dense blocks."""
    pp_names = _pp_names(KW["post_processor"], model.depth)
    N, nf = X.shape[0], model.nr_features
    pending = []
    if not smat.issparse(X):
        for s in range(0, N, batch):
            xb = prepare_queries(X[s : s + batch], model.bias)
            xb = np.vstack([xb, np.zeros((batch - xb.shape[0], xb.shape[1]), np.float32)])
            labels, scores = chain_predict(torch.from_numpy(xb), model.layers, KW["beam_size"], KW["only_topk"], pp_names)
            pending.append((labels[: N - s], scores[: N - s]))
        return _fetch_topk(pending, KW["only_topk"], model.nr_labels)
    cap = max(64, 1 << (int(np.diff(X.indptr).max()) - 1).bit_length())
    for s in range(0, N, batch):
        ids, vals = pad_query_rows(*prepare_queries_padded(X[s : s + batch], cap=cap), batch, nf)
        if wire == "float32":
            qids, qvals = torch.from_numpy(ids), torch.from_numpy(vals)
        else:
            buf = encode_wire_batch(ids, vals, nf, wire)
            qids, qvals = decode_wire_batch(torch.from_numpy(buf.view(np.int16)), nf, cap, wire)
        labels, scores = model.predict_padded(qids, qvals, beam_size=KW["beam_size"], only_topk=KW["only_topk"],
                                              pp_names=pp_names, has_dense=model.uses_dense_queries(batch, cap))
        pending.append((labels[: N - s], scores[: N - s]))
    return _fetch_topk(pending, KW["only_topk"], model.nr_labels)


@pytest.mark.parametrize("wire", WIRES + ["dense_X"])
def test_predict_answers_as_the_host_padded_path(model, X, wire):
    """Top-k labels and scores equal to the host-padded path's bit for bit;
    only sparse float32-wire batches are padded on the device."""
    Q = X.toarray() if wire == "dense_X" else X
    profile_util.reset()
    got = model.predict(Q, batch_size=64, wire_value_dtype="float32" if wire == "dense_X" else wire, **KW)
    padded_on_device = profile_util.snapshot()["counters"].get("pecos.pad.device", 0)
    profile_util.reset()
    ref = host_padded_predict(model, Q, wire, 64)
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_array_equal(got.data.view(np.int32), ref.data.view(np.int32))
    assert padded_on_device == (4 if wire == "float32" else 0)
