"""Sparse-matrix I/O, top-k CSR helpers and ranking metrics (numpy/scipy).

The subset of ``pecos_tpu/utils/smat_util.py`` that the predict and train
paths, their CLIs and model surgery use, with the same on-disk formats:
``.npz`` (scipy sparse) for sparse and ``.npy`` for dense matrices.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Union

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


def hstack_csr(mats: Sequence[Matrix]) -> smat.csr_matrix:
    return smat.hstack([m.tocsr() if smat.issparse(m) else smat.csr_matrix(m) for m in mats], format="csr")


def hstack_csc(mats: Sequence[smat.spmatrix]) -> smat.csc_matrix:
    return smat.hstack([m.tocsc() for m in mats], format="csc")


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
