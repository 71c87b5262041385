"""The port's smat_util, spgemm_util, calibration and small host utilities
against the JAX package's, on the same numpy-seeded inputs.

Tolerances: functions that run the same numpy/scipy arithmetic are held to
exact equality.  CsrEnsembler results: indices exact, data within rtol 1e-6
(the port computes the rank methods' weights without a loop over rows).
spgemm_atb: bit-equal to the JAX package's native product (both
packages' host cores add the same float32 terms in the same order;
tests/test_torch_spgemm.py holds the other cases).  Platt A and B within 1e-6.
"""

import numpy as np
import pytest
import scipy.sparse as smat

from pecos_tpu.utils import smat_util as jsm
from pecos_tpu_torch.utils import smat_util as tsm


def _csr(rng, n=30, L=40, density=0.2, ties=False):
    A = smat.random(n, L, density=density, format="csr", random_state=np.random.RandomState(int(rng.integers(1 << 30))))
    A.data = (rng.integers(0, 4, A.nnz) / 4.0 + 0.25 if ties else rng.uniform(-2, 2, A.nnz)).astype(np.float32)
    A.sort_indices()
    return A


def _assert_csr_equal(got, want, rtol=0.0):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    if rtol:
        np.testing.assert_allclose(got.data, want.data, rtol=rtol, atol=0)
    else:
        np.testing.assert_array_equal(got.data, want.data)


@pytest.mark.parametrize("topk", [None, 3, 50])
def test_dense_to_csr(topk):
    X = np.random.default_rng(0).standard_normal((10, 12)).astype(np.float32)
    X[2] = 0.0
    _assert_csr_equal(tsm.dense_to_csr(X, topk=topk, batch=4), jsm.dense_to_csr(X, topk=topk, batch=4))


def test_rows_stacks_and_bias():
    rng = np.random.default_rng(1)
    A, B = _csr(rng), _csr(rng)
    D = rng.standard_normal((30, 5)).astype(np.float32)
    rows = np.array([3, 0, 7, 7])
    for got, want in zip(tsm.get_row_submatrices([A, None, D], rows), jsm.get_row_submatrices([A, None, D], rows)):
        if want is None:
            assert got is None
        elif smat.issparse(want):
            _assert_csr_equal(got, want)
        else:
            np.testing.assert_array_equal(got, want)
    _assert_csr_equal(tsm.vstack_csr([A, B]), jsm.vstack_csr([A, B]))
    _assert_csr_equal(tsm.block_diag_csr([A, B[:5]]), jsm.block_diag_csr([A, B[:5]]))
    for bias in (0.0, 1.0, 2.5):
        _assert_csr_equal(tsm.append_bias(A, bias).tocsr(), jsm.append_bias(A, bias).tocsr())
        np.testing.assert_array_equal(tsm.append_bias(D, bias), jsm.append_bias(D, bias))
    cols_t, cols_j = tsm.get_csc_col_nonzero(A), jsm.get_csc_col_nonzero(A)
    assert len(cols_t) == len(cols_j) == A.shape[1]
    for a, b in zip(cols_t, cols_j):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", [1, 4, 12])
def test_topk_csr_from_dense(k):
    rng = np.random.default_rng(2)
    S = rng.standard_normal((9, 12)).astype(np.float32)
    S[0] = 0.5  # one row of ties
    _assert_csr_equal(tsm.topk_csr_from_dense(S, k), jsm.topk_csr_from_dense(S, k))


def test_padded_roundtrip():
    rng = np.random.default_rng(3)
    A = _csr(rng)
    for kw in ({}, {"capacity": 32}, {"round_to": 16, "pad_index": -1}):
        got, want = tsm.csr_to_padded(A, **kw), jsm.csr_to_padded(A, **kw)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.values, want.values)
        assert (got.shape, got.pad_index, got.capacity) == (want.shape, want.pad_index, want.capacity)
        _assert_csr_equal(tsm.padded_to_csr(got), jsm.padded_to_csr(want))
        _assert_csr_equal(tsm.padded_to_csr(got), A)
    with pytest.raises(ValueError, match="capacity"):
        tsm.csr_to_padded(A, capacity=1)


def test_cocluster_spectral_embeddings():
    """Same singular vectors up to each column's sign (svds draws its start
    vector from numpy's global state, seeded alike before each call)."""
    rng = np.random.default_rng(4)
    A = smat.random(60, 40, density=0.15, format="csr", random_state=np.random.RandomState(4))
    A.data = rng.uniform(0.1, 1.0, A.nnz)
    np.random.seed(0)
    want = jsm.get_cocluster_spectral_embeddings(A, dim=5)
    np.random.seed(0)
    got = tsm.get_cocluster_spectral_embeddings(A, dim=5)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        sign = np.sign((g * w).sum(axis=0))
        np.testing.assert_allclose(g * sign, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("method", ["average", "rank_average", "sigmoid_average", "softmax_average", "round_robin"])
@pytest.mark.parametrize("ties", [False, True])
def test_csr_ensembler(method, ties):
    rng = np.random.default_rng(5)
    mats = [_csr(rng, ties=ties) for _ in range(3)]
    keep = np.ones(mats[1].shape[0], np.float32)
    keep[4] = 0.0  # an empty row in one input
    mats[1] = (smat.diags(keep) @ mats[1]).tocsr()
    mats[1].eliminate_zeros()
    got = getattr(tsm.CsrEnsembler, method)(*mats)
    want = getattr(jsm.CsrEnsembler, method)(*mats)
    _assert_csr_equal(got, want, rtol=1e-6)
    # each row descending, ties broken to the lower label id
    for s, e in zip(got.indptr[:-1], got.indptr[1:]):
        d, i = got.data[s:e], got.indices[s:e]
        assert (np.diff(d) <= 0).all()
        assert all(i[j] < i[j + 1] for j in range(len(d) - 1) if d[j] == d[j + 1])
    with pytest.raises(ValueError, match="share shape"):
        getattr(tsm.CsrEnsembler, method)(mats[0], mats[1][:5])


def test_spgemm_atb_matches_native():
    from pecos_tpu.utils.spgemm_util import spgemm_atb as jax_spgemm
    from pecos_tpu_torch.utils.spgemm_util import spgemm_atb

    rng = np.random.default_rng(6)
    Y = smat.random(200, 30, density=0.05, format="csr", random_state=np.random.RandomState(6)).astype(np.float32)
    X = smat.random(200, 90, density=0.1, format="csr", random_state=np.random.RandomState(7)).astype(np.float32)
    X.data = rng.uniform(0.1, 1.0, X.nnz).astype(np.float32)
    got, want = spgemm_atb(Y, X), jax_spgemm(Y, X)
    assert got.dtype == want.dtype == np.float32 and got.has_canonical_format
    _assert_csr_equal(got, want.tocsr())


def test_platt_matches_jax():
    from pecos_tpu.xmc.calibration import apply_platt as japply, fit_platt_transform as jfit
    from pecos_tpu_torch.xmc.calibration import apply_platt, fit_platt_transform

    rng = np.random.default_rng(7)
    s = rng.standard_normal(500)
    y = (s + 0.7 * rng.standard_normal(500) > 0).astype(np.float64)
    A, B, status = fit_platt_transform(s, y)
    jA, jB, jstatus = jfit(s, y)
    assert status == jstatus == 0
    assert abs(A - jA) <= 1e-6 and abs(B - jB) <= 1e-6
    np.testing.assert_allclose(apply_platt(s, A, B), japply(s, jA, jB), rtol=1e-6)
    # -1/+1 targets are read as 0/1
    assert fit_platt_transform(s, 2 * y - 1)[:2] == (A, B)


def test_aux_utils():
    import argparse

    from pecos_tpu_torch.utils.cli import str2bool
    from pecos_tpu_torch.utils.parallel_util import run_parallel
    from pecos_tpu_torch.utils.profile_util import MemInfo

    assert "rss" in MemInfo.mem_info()
    assert isinstance(MemInfo.device_mem_info(), str)
    assert str2bool("yes") and not str2bool("0") and str2bool(True)
    with pytest.raises(argparse.ArgumentTypeError):
        str2bool("maybe")
    assert run_parallel(lambda x: x * 2, [1, 2, 3], num_workers=1) == [2, 4, 6]
