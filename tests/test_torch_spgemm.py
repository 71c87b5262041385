"""ROADMAP F15: the port's SpGEMM (Z = Y^T X, core/csrc/spgemm.cpp) and the PIFA
label embeddings built on it against the JAX package's native product, on the
same numpy-seeded inputs.

Tolerance 0: both run the same float32 multiply-adds in the same order (Y's
CSC entries, then each X row's entries), so indptr, indices and data are held
with ``np.array_equal`` and the dtype is float32.  The cases are the inputs a
scipy product treats otherwise: sums that cancel to exactly 0 and explicit
zeros (kept as entries), unsorted and duplicate column indices in X (rows come
out sorted, duplicates added in order), float64 operands (cast to float32
before the product), empty label columns and empty X rows, fewer and more
labels than threads.
"""

import numpy as np
import pytest
import scipy.sparse as smat

from pecos_tpu.utils.spgemm_util import spgemm_atb as jax_spgemm
from pecos_tpu.xmc import LabelEmbeddingFactory as JaxLEF
from pecos_tpu_torch.utils.spgemm_util import spgemm_atb
from pecos_tpu_torch.xmc import LabelEmbeddingFactory


def _random(n, m, density, seed, values, dtype=np.float32):
    A = smat.random(n, m, density=density, format="csr", random_state=np.random.RandomState(seed), dtype=dtype)
    A.data = values(np.random.default_rng(seed), A.nnz).astype(dtype)
    return A


def _labels(n, L, seed, density=0.05):
    return _random(n, L, density, seed, lambda rng, k: np.ones(k))


def _case(name):
    """(Y, X, threads) of one case."""
    pos = lambda rng, k: rng.uniform(0.1, 1.0, k)
    if name == "positive":
        return _labels(200, 30, 6), _random(200, 90, 0.1, 7, pos), -1
    if name == "explicit_zeros":
        X = _random(200, 90, 0.1, 8, pos)
        X.data[::3] = 0.0
        return _labels(200, 30, 9), X, -1
    if name == "cancel":
        # values in {-1, -0.5, 0.5, 1} over few columns: many label rows sum to exactly 0
        X = _random(300, 12, 0.3, 10, lambda rng, k: rng.choice([-1.0, -0.5, 0.5, 1.0], k))
        return _labels(300, 40, 11, density=0.1), X, -1
    if name == "cancel_small":
        # +1 and -1 cancel at (0, 0); X's row 2 is an explicit zero
        Y = smat.csr_matrix(np.array([[1, 1], [1, 0], [0, 1]], np.float32))
        X = smat.csr_matrix(
            (np.array([1, 2, -1, 3, 0], np.float32), np.array([0, 2, 0, 1, 2]), np.array([0, 2, 4, 5])), shape=(3, 3)
        )
        return Y, X, -1
    if name == "empty":
        Y = _labels(200, 30, 12, density=0.1).tolil()
        Y[:, ::4] = 0  # empty label columns
        X = _random(200, 90, 0.1, 13, pos).tolil()
        X[::3] = 0  # empty instance rows
        return Y.tocsr(), X.tocsr(), -1
    if name == "unsorted_duplicates":
        rng = np.random.default_rng(14)
        lens = rng.integers(0, 12, 150)
        indices = rng.integers(0, 40, int(lens.sum())).astype(np.int32)  # unsorted, with repeats
        data = rng.standard_normal(len(indices)).astype(np.float32)
        X = smat.csr_matrix((data, indices, np.concatenate([[0], np.cumsum(lens)])), shape=(150, 40))
        assert not X.has_sorted_indices
        return _labels(150, 25, 15, density=0.1), X, -1
    if name == "float64":
        X = _random(200, 90, 0.1, 16, lambda rng, k: rng.standard_normal(k), dtype=np.float64)
        Y = _random(200, 30, 0.05, 17, lambda rng, k: rng.uniform(0.5, 2.0, k), dtype=np.float64)
        return Y, X, -1
    if name == "labels_below_threads":
        return _labels(100, 3, 18, density=0.3), _random(100, 50, 0.1, 19, pos), 8
    if name == "labels_above_threads":
        return _labels(400, 300, 20, density=0.02), _random(400, 60, 0.1, 21, lambda rng, k: rng.standard_normal(k)), 3
    raise KeyError(name)


CASES = [
    "positive", "explicit_zeros", "cancel", "cancel_small", "empty", "unsorted_duplicates", "float64",
    "labels_below_threads", "labels_above_threads",
]


def _assert_bit_equal(got, want):
    assert got.shape == want.shape
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.data, want.data)


def _assert_canonical(A):
    for s, e in zip(A.indptr[:-1], A.indptr[1:]):
        assert (np.diff(A.indices[s:e]) > 0).all()


@pytest.mark.parametrize("case", CASES)
def test_spgemm_atb_bit_equal_to_jax(case):
    Y, X, threads = _case(case)
    got, want = spgemm_atb(Y, X, threads=threads), jax_spgemm(Y, X, threads=threads)
    _assert_bit_equal(got, want)
    _assert_canonical(got)
    if case.startswith("cancel") or case == "explicit_zeros":
        assert (got.data == 0).any(), "the case holds no exact zero"


@pytest.mark.parametrize("case", ["positive", "cancel", "labels_above_threads"])
def test_spgemm_atb_threads_do_not_change_bits(case):
    Y, X, _ = _case(case)
    one = spgemm_atb(Y, X, threads=1)
    for threads in (-1, 2, 7):
        _assert_bit_equal(spgemm_atb(Y, X, threads=threads), one)
    _assert_bit_equal(one, jax_spgemm(Y, X, threads=1))
    _assert_bit_equal(one, jax_spgemm(Y, X, threads=-1))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("method", ["pifa", "pifa_lf_concat"])
def test_pifa_bit_equal_to_jax(case, method):
    Y, X, _ = _case(case)
    Z = np.random.default_rng(22).standard_normal((Y.shape[1], 7)).astype(np.float32)
    got = LabelEmbeddingFactory.create(Y, X, Z, method=method)
    want = JaxLEF.create(Y, X, Z, method=method)
    _assert_bit_equal(got, want)
    _assert_canonical(got)


def test_spgemm_atb_rejects_bad_operands():
    Y, X, _ = _case("positive")
    with pytest.raises(ValueError, match="rows"):
        spgemm_atb(Y[:-1], X)
    bad = smat.csr_matrix((np.ones(1, np.float32), np.array([90], np.int32), np.array([0, 1] + [1] * 199)), shape=(200, 90))
    with pytest.raises(ValueError, match="outside"):
        spgemm_atb(Y, bad)
