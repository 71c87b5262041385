"""Z = Y^T . X, the product behind PIFA label embeddings, in the host core.

The port of ``pecos_tpu/utils/spgemm_util.py``: the product runs in
``core/csrc/spgemm.cpp`` on the host's threads, with the JAX package's float32
arithmetic in its order, so Z is the JAX package's bit for bit.  A failed
build of the host core raises with the compiler's output; there is no Python
fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np
import scipy.sparse as smat

from pecos_tpu_torch.core import load_library

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_fp = ctypes.POINTER(ctypes.c_float)


def spgemm_atb(Y: smat.spmatrix, X: smat.spmatrix, threads: int = -1) -> smat.csr_matrix:
    """Z = Y.T @ X as float32 CSR with sorted rows; entries that sum to exactly
    0 are kept.  Y (N x L) and X (N x D) are cast as the JAX package casts
    them: Y to CSC, X to CSR, float32 values.  ``threads`` <= 0 uses the
    host's threads; the result does not depend on it."""
    if Y.shape[0] != X.shape[0]:
        raise ValueError(f"spgemm_atb: Y has {Y.shape[0]} rows and X {X.shape[0]}")
    Yc = Y.tocsc()
    Xr = X.tocsr()
    N, L = Yc.shape
    D = Xr.shape[1]
    y_indptr = np.ascontiguousarray(Yc.indptr, np.int64)
    y_indices = np.ascontiguousarray(Yc.indices, np.int32)
    y_data = np.ascontiguousarray(Yc.data, np.float32)
    x_indptr = np.ascontiguousarray(Xr.indptr, np.int64)
    x_indices = np.ascontiguousarray(Xr.indices, np.int32)
    x_data = np.ascontiguousarray(Xr.data, np.float32)
    for name, idx, hi in (("Y", y_indices, N), ("X", x_indices, D)):
        if idx.size and (idx.min() < 0 or idx.max() >= hi):
            raise ValueError(f"spgemm_atb: {name} has an index outside [0, {hi})")
    lib = load_library()
    h = lib.spgemm_atb(
        N, L, D,
        y_indptr.ctypes.data_as(_i64p), y_indices.ctypes.data_as(_i32p), y_data.ctypes.data_as(_fp),
        x_indptr.ctypes.data_as(_i64p), x_indices.ctypes.data_as(_i32p), x_data.ctypes.data_as(_fp),
        threads,
    )
    if not h:
        raise MemoryError(f"spgemm_atb: the host ran out of memory for Y^T X of {L} x {D}")
    try:
        nnz = lib.spgemm_nnz(h)
        indptr = np.empty(L + 1, np.int64)
        indices = np.empty(nnz, np.int32)
        data = np.empty(nnz, np.float32)
        lib.spgemm_fill(h, indptr.ctypes.data_as(_i64p), indices.ctypes.data_as(_i32p), data.ctypes.data_as(_fp))
    finally:
        lib.spgemm_free(h)
    return smat.csr_matrix((data, indices, indptr), shape=(L, D))
