"""Z = Y^T . X, the product behind PIFA label embeddings.

The port of ``pecos_tpu/utils/spgemm_util.py``, over scipy's sparse product
(the port's PIFA already uses it); the name and signature stay.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as smat


def spgemm_atb(Y: smat.spmatrix, X: smat.spmatrix, threads: int = -1) -> smat.csr_matrix:
    """Z = Y.T @ X as canonical float32 CSR (sorted indices, no duplicates),
    from float32 operands as the JAX package's native product takes them.
    ``threads`` is accepted for that signature; scipy's product runs on one
    thread."""
    Z = (Y.T.tocsr().astype(np.float32) @ X.tocsr().astype(np.float32)).tocsr()
    Z.sum_duplicates()
    Z.sort_indices()
    return Z
