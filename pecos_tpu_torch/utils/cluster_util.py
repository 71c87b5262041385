"""Cluster-chain tables for the beam search (numpy/scipy).

Predict needs one thing of ``pecos_tpu.utils.cluster_util.ClusterChain``: the
padded children table of one level's cluster matrix.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as smat


def padded_children(C: smat.spmatrix) -> Tuple[np.ndarray, int]:
    """Children table of a cluster matrix C (n_children, n_parents):
    ``(n_parents, max_children)`` int32, entry [p, j] the j-th child of parent
    p in ascending id order, -1 where p has fewer children."""
    C = C.tocsc()
    C.sort_indices()
    n_parents = C.shape[1]
    counts = np.diff(C.indptr)
    max_c = int(counts.max()) if n_parents else 0
    table = np.full((n_parents, max_c), -1, dtype=np.int32)
    rows = np.repeat(np.arange(n_parents), counts)
    offs = np.arange(C.nnz) - np.repeat(C.indptr[:-1], counts)
    table[rows, offs] = C.indices
    return table, max_c
