"""Sparse-matrix toolkit: I/O, conversions, stacking, top-k CSR, the padded
row format, ensembling of prediction matrices and ranking metrics (numpy/scipy).

The port of ``pecos_tpu/utils/smat_util.py``, with the same on-disk formats:
``.npz`` (scipy sparse) for sparse and ``.npy`` for dense matrices.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import scipy.sparse as smat

Matrix = Union[np.ndarray, smat.spmatrix]


def save_matrix(path: str, X: Matrix) -> None:
    """Save dense (npy) or sparse (npz, scipy format) matrix."""
    if isinstance(X, np.ndarray):
        np.save(path if path.endswith(".npy") else path + ".npy", X)
    elif smat.issparse(X):
        if not path.endswith(".npz"):
            path = path + ".npz"
        smat.save_npz(path, X if X.format in ("csr", "csc", "coo") else X.tocsr())
    else:
        raise ValueError(f"cannot save matrix of type {type(X)}")


def load_matrix(path: str, dtype=np.float32) -> Matrix:
    """Load a matrix saved by :func:`save_matrix` (also accepts bare .npy/.npz)."""
    if not os.path.exists(path):
        for ext in (".npz", ".npy"):
            if os.path.exists(path + ext):
                path = path + ext
                break
    if path.endswith(".npy"):
        M = np.load(path)
    elif path.endswith(".npz"):
        M = smat.load_npz(path)
    else:
        raise ValueError(f"cannot load matrix from {path}")
    return M.astype(dtype) if dtype is not None else M


def load_feature_matrix(path: str, dtype=np.float32) -> Matrix:
    return load_matrix(path, dtype=dtype)


def load_label_matrix(path: str, dtype=np.float32) -> smat.csr_matrix:
    Y = load_matrix(path, dtype=dtype)
    if isinstance(Y, np.ndarray):
        Y = smat.csr_matrix(Y)
    return Y.tocsr()


def dense_to_csr(X: np.ndarray, topk: Optional[int] = None, batch: int = 4096) -> smat.csr_matrix:
    """Dense rows as CSR, keeping only the ``topk`` entries of largest
    magnitude per row when given (explicit zeros dropped)."""
    X = np.asarray(X)
    if topk is None or topk >= X.shape[1]:
        return smat.csr_matrix(X)
    blocks = []
    for s in range(0, X.shape[0], batch):
        xb = X[s : s + batch]
        idx = np.argpartition(-np.abs(xb), topk - 1, axis=1)[:, :topk]
        rows = np.repeat(np.arange(xb.shape[0]), topk)
        cols = idx.ravel()
        blocks.append(smat.csr_matrix((xb[rows, cols], (rows, cols)), shape=xb.shape))
    out = smat.vstack(blocks, format="csr")
    out.eliminate_zeros()
    return out


def get_row_submatrices(matrices: Sequence[Optional[Matrix]], row_indices: np.ndarray) -> List[Optional[Matrix]]:
    """The same row subset of each matrix (None stays None)."""
    return [None if M is None else M[row_indices] for M in matrices]


def append_bias(X: Matrix, bias: float) -> Matrix:
    """X with a constant column ``bias`` appended; X itself when bias <= 0."""
    if bias <= 0:
        return X
    col = np.full((X.shape[0], 1), bias, dtype=np.float32)
    if smat.issparse(X):
        return smat.hstack([X.tocsr(), smat.csr_matrix(col)], format="csr")
    return np.hstack([X, col])


def sorted_csr(A: smat.csr_matrix, only_topk: Optional[int] = None) -> smat.csr_matrix:
    """CSR whose row entries are sorted by descending value (ties keep column
    order), truncated to ``only_topk`` per row."""
    A = A.tocsr()
    n = A.shape[0]
    row_nnz = np.diff(A.indptr)
    row = np.repeat(np.arange(n), row_nnz)
    order = np.lexsort((-A.data, row))
    counts = row_nnz
    if only_topk is not None:
        rank = np.arange(A.nnz) - np.repeat(A.indptr[:-1], row_nnz)
        order = order[rank < only_topk]
        counts = np.minimum(row_nnz, only_topk)
    indptr = np.zeros(n + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(counts)
    return smat.csr_matrix((A.data[order], A.indices[order], indptr), shape=A.shape)


def topk_csr_from_dense(scores: np.ndarray, only_topk: int) -> smat.csr_matrix:
    """Dense (n, L) scores as CSR keeping the top-k of each row, sorted descending."""
    n, L = scores.shape
    k = min(only_topk, L)
    idx = np.argpartition(-scores, k - 1, axis=1)[:, :k]
    vals = np.take_along_axis(scores, idx, axis=1)
    order = np.argsort(-vals, axis=1, kind="stable")
    idx = np.take_along_axis(idx, order, axis=1)
    vals = np.take_along_axis(vals, order, axis=1)
    indptr = np.arange(0, (n + 1) * k, k)
    return smat.csr_matrix((vals.ravel(), idx.ravel(), indptr), shape=(n, L))


def csr_from_topk_arrays(indices: np.ndarray, values: np.ndarray, num_cols: int) -> smat.csr_matrix:
    """CSR from padded (n, k) index/value arrays; entries with index -1 are
    dropped and each row keeps the order of its arrays (rank order)."""
    mask = indices != -1
    indptr = np.concatenate([[0], np.cumsum(mask.sum(axis=1))])
    return smat.csr_matrix((values[mask], indices[mask], indptr), shape=(indices.shape[0], num_cols))


def binarized(X: smat.spmatrix) -> smat.csr_matrix:
    """CSR copy of X with every stored entry set to 1."""
    X = X.tocsr(copy=True)
    X.data[:] = 1.0
    return X


def csr_rowwise_mul(A: smat.spmatrix, v: np.ndarray) -> smat.csr_matrix:
    """CSR copy of A with row i multiplied by v[i]."""
    A = A.tocsr(copy=True)
    A.data *= np.repeat(v, np.diff(A.indptr))
    return A


def normalize(X: Matrix, axis: int = 1, norm: str = "l2", copy: bool = True) -> Matrix:
    """Rows (axis=1) or columns (axis=0) of a dense or sparse X scaled to unit
    l1, l2 or max norm; all-zero rows stay zero."""
    if axis == 0:
        return normalize(X.T, axis=1, norm=norm, copy=copy).T
    if norm not in ("l1", "l2", "max"):
        raise ValueError(f"unknown norm {norm!r}: use l1, l2 or max")
    if smat.issparse(X):
        X = X.tocsr(copy=copy)
        if norm == "l2":
            nrm = np.sqrt(np.asarray(X.multiply(X).sum(axis=1)).ravel())
        elif norm == "l1":
            nrm = np.asarray(abs(X).sum(axis=1)).ravel()
        else:
            nrm = np.asarray(abs(X).max(axis=1).todense()).ravel()
        nrm[nrm == 0] = 1.0
        return csr_rowwise_mul(X, 1.0 / nrm)
    X = np.array(X, copy=copy)
    if norm == "l2":
        nrm = np.linalg.norm(X, axis=1)
    elif norm == "l1":
        nrm = np.abs(X).sum(axis=1)
    else:
        nrm = np.abs(X).max(axis=1)
    nrm[nrm == 0] = 1.0
    return X / nrm[:, None]


def vstack_csr(mats: Sequence[smat.spmatrix]) -> smat.csr_matrix:
    return smat.vstack([m.tocsr() for m in mats], format="csr")


def hstack_csr(mats: Sequence[Matrix]) -> smat.csr_matrix:
    return smat.hstack([m.tocsr() if smat.issparse(m) else smat.csr_matrix(m) for m in mats], format="csr")


def hstack_csc(mats: Sequence[smat.spmatrix]) -> smat.csc_matrix:
    return smat.hstack([m.tocsc() for m in mats], format="csc")


def block_diag_csr(mats: Sequence[smat.spmatrix]) -> smat.csr_matrix:
    return smat.block_diag([m.tocsr() for m in mats], format="csr")


def block_diag_csc(mats: Sequence[smat.spmatrix]) -> smat.csc_matrix:
    return smat.block_diag([m.tocsc() for m in mats], format="csc")


def get_sparsified_coo(coo: smat.coo_matrix, selected_rows, selected_cols) -> smat.coo_matrix:
    """COO of the same shape keeping only entries in selected rows x selected cols."""
    row_ok = np.zeros(coo.shape[0], bool)
    row_ok[np.asarray(selected_rows, dtype=np.int64)] = True
    col_ok = np.zeros(coo.shape[1], bool)
    col_ok[np.asarray(selected_cols, dtype=np.int64)] = True
    keep = row_ok[coo.row] & col_ok[coo.col]
    return smat.coo_matrix((coo.data[keep], (coo.row[keep], coo.col[keep])), shape=coo.shape)


@dataclasses.dataclass
class PaddedCsr:
    """Row-padded sparse matrix of static shape (n_rows, capacity):
    ``indices[i, j]`` is a column id (``pad_index`` where padded) and
    ``values[i, j]`` its value (0 where padded)."""

    indices: np.ndarray  # (n, cap) int32
    values: np.ndarray  # (n, cap) float32
    shape: Tuple[int, int]
    pad_index: int

    @property
    def capacity(self) -> int:
        return self.indices.shape[1]


def csr_to_padded(
    A: smat.spmatrix, capacity: Optional[int] = None, round_to: int = 8, pad_index: Optional[int] = None
) -> PaddedCsr:
    """A as a PaddedCsr whose capacity is ``capacity``, or the largest row
    nnz rounded up to ``round_to``; the pad id defaults to A's column count.
    Raises ValueError when a row holds more than the capacity."""
    A = A.tocsr()
    n = A.shape[0]
    nnz_per_row = np.diff(A.indptr)
    max_nnz = int(nnz_per_row.max()) if n else 0
    cap = capacity if capacity is not None else max(round_to, -(-max_nnz // round_to) * round_to)
    if max_nnz > cap:
        raise ValueError(f"capacity {cap} < max row nnz {max_nnz}")
    pad = A.shape[1] if pad_index is None else pad_index
    idx = np.full((n, cap), pad, dtype=np.int32)
    val = np.zeros((n, cap), dtype=np.float32)
    rows = np.repeat(np.arange(n), nnz_per_row)
    offs = np.arange(A.nnz) - np.repeat(A.indptr[:-1], nnz_per_row)
    idx[rows, offs] = A.indices
    val[rows, offs] = A.data
    return PaddedCsr(indices=idx, values=val, shape=A.shape, pad_index=pad)


def padded_to_csr(P: PaddedCsr) -> smat.csr_matrix:
    mask = P.indices != P.pad_index
    indptr = np.concatenate([[0], np.cumsum(mask.sum(axis=1))])
    return smat.csr_matrix((P.values[mask], P.indices[mask], indptr), shape=P.shape)


def get_cocluster_spectral_embeddings(A: smat.spmatrix, dim: int = 24):
    """Bipartite spectral co-clustering embeddings (Dhillon 2001): (row
    embedding (m, dim), column embedding (n, dim)) from the singular vectors
    2..dim+1 of D1^{-1/2} A D2^{-1/2}, D1 and D2 the row and column sums of |A|."""
    from scipy.sparse.linalg import svds

    A = A.tocsr().astype(np.float64)
    d1 = np.asarray(abs(A).sum(axis=1)).ravel()
    d2 = np.asarray(abs(A).sum(axis=0)).ravel()
    d1[d1 == 0] = 1.0
    d2[d2 == 0] = 1.0
    D1 = smat.diags(1.0 / np.sqrt(d1))
    D2 = smat.diags(1.0 / np.sqrt(d2))
    An = D1 @ A @ D2
    U, s, Vt = svds(An, k=min(dim + 1, min(An.shape) - 1))
    order = np.argsort(-s)
    U, Vt = U[:, order][:, 1 : dim + 1], Vt[order][1 : dim + 1]  # the leading vector is trivial
    return (D1 @ U).astype(np.float32), (D2 @ Vt.T).astype(np.float32)


def get_csc_col_nonzero(M: smat.spmatrix) -> List[np.ndarray]:
    """The sorted row ids of each column's nonzeros."""
    M = M.tocsc()
    return [np.sort(M.indices[M.indptr[c] : M.indptr[c + 1]]) for c in range(M.shape[1])]


def _row_ranks(A: smat.csr_matrix) -> np.ndarray:
    """Each entry's position within its row (0 for the first)."""
    row_nnz = np.diff(A.indptr)
    return np.arange(A.nnz) - np.repeat(A.indptr[:-1], row_nnz)


class CsrEnsembler:
    """Combine prediction matrices of one shape into one, rows sorted by
    descending score (ties: the lower label id first, as ``sorted_csr`` keeps
    the column order of scipy's sums)."""

    @staticmethod
    def check_validity(*args: smat.csr_matrix) -> None:
        shapes = {a.shape for a in args}
        if len(shapes) != 1:
            raise ValueError(f"ensemble inputs must share shape, got {shapes}")

    @staticmethod
    def average(*args: smat.csr_matrix) -> smat.csr_matrix:
        """The mean of the scores."""
        CsrEnsembler.check_validity(*args)
        return sorted_csr((sum(a.tocsr() for a in args) / len(args)).tocsr())

    @staticmethod
    def rank_average(*args: smat.csr_matrix) -> smat.csr_matrix:
        """The mean of 1 / (1 + rank) over the inputs, rank 0 the best score of a row."""
        CsrEnsembler.check_validity(*args)
        acc = smat.csr_matrix(args[0].shape, dtype=np.float32)
        for a in args:
            ranks = sorted_csr(a.tocsr()).astype(np.float32)
            ranks.data[:] = 1.0 / (1.0 + _row_ranks(ranks))
            acc = acc + ranks
        return sorted_csr((acc / len(args)).tocsr())

    @staticmethod
    def sigmoid_average(*args: smat.csr_matrix) -> smat.csr_matrix:
        """The mean of sigmoid(score)."""
        CsrEnsembler.check_validity(*args)
        acc = smat.csr_matrix(args[0].shape, dtype=np.float32)
        for a in args:
            b = a.tocsr(copy=True)
            b.data = 1.0 / (1.0 + np.exp(-b.data))
            acc = acc + b
        return sorted_csr((acc / len(args)).tocsr())

    @staticmethod
    def softmax_average(*args: smat.csr_matrix) -> smat.csr_matrix:
        """The mean of each row's softmax over its stored scores."""
        CsrEnsembler.check_validity(*args)
        acc = smat.csr_matrix(args[0].shape, dtype=np.float32)
        for a in args:
            b = a.tocsr(copy=True)
            # row by row: numpy's pairwise sum of each row, the JAX package's
            # rounding, so near-ties order alike in both packages
            for s, e in zip(b.indptr[:-1], b.indptr[1:]):
                if e > s:
                    x = np.exp(b.data[s:e] - b.data[s:e].max())
                    b.data[s:e] = x / x.sum()
            acc = acc + b
        return sorted_csr((acc / len(args)).tocsr())

    @staticmethod
    def round_robin(*args: smat.csr_matrix) -> smat.csr_matrix:
        """The entrywise max of base^-rank x (1 - m / base^2) over the inputs
        m = 0, 1, ..., base = inputs + 1: ranks interleave across the inputs,
        an earlier input first at equal rank."""
        CsrEnsembler.check_validity(*args)
        base = len(args) + 1.0
        acc = smat.csr_matrix(args[0].shape, dtype=np.float32)
        for m, a in enumerate(args):
            ranks = sorted_csr(a.tocsr()).astype(np.float32)
            ranks.data[:] = base ** (-_row_ranks(ranks).astype(np.float64)) * (1.0 - m / base / base)
            acc = acc.maximum(ranks)
        return sorted_csr(acc.tocsr())


@dataclasses.dataclass
class Metrics:
    prec: np.ndarray  # precision@1..k
    recall: np.ndarray  # recall@1..k

    @classmethod
    def generate(cls, tY: smat.csr_matrix, pY: smat.csr_matrix, topk: int = 10) -> "Metrics":
        """Precision@k / Recall@k of predictions pY against truth tY.

        P@k = (1/k) * mean_i |top-k(pY_i) ∩ Y_i| ; R@k = mean_i |top-k ∩ Y_i|/|Y_i|.
        Ranking is by descending score within each pY row.
        """
        if tY.shape != pY.shape:
            raise ValueError(f"shape mismatch {tY.shape} vs {pY.shape}")
        tY = tY.tocsr()
        pY = sorted_csr(pY.tocsr(), only_topk=topk)
        n, L = tY.shape
        num_true = np.maximum(np.diff(tY.indptr), 1).astype(np.float64)
        # membership by global (row, label) keys
        p_nnz = np.diff(pY.indptr)
        p_row = np.repeat(np.arange(n, dtype=np.int64), p_nnz)
        p_rank = np.arange(pY.nnz) - np.repeat(pY.indptr[:-1], p_nnz)
        t_row = np.repeat(np.arange(n, dtype=np.int64), np.diff(tY.indptr))
        is_hit = np.isin(p_row * L + pY.indices, t_row * L + tY.indices)
        hits = np.zeros((n, topk), dtype=np.float64)
        hits[p_row[is_hit], p_rank[is_hit]] = 1.0
        cum = np.cumsum(hits, axis=1)
        ks = np.arange(1, topk + 1, dtype=np.float64)
        prec = (cum / ks[None, :]).mean(axis=0)
        recall = (cum / num_true[:, None]).mean(axis=0)
        return cls(prec=prec, recall=recall)

    def __str__(self) -> str:
        fmt = lambda v: " ".join(f"{100*x:.2f}" for x in v)
        return f"prec   = {fmt(self.prec)}\nrecall = {fmt(self.recall)}"
