"""ClusterChain, the hierarchical label tree, and its padded children tables
(numpy/scipy; counterpart of ``pecos_tpu/utils/cluster_util.py``).

A chain is a list of sparse matrices ``C_0 .. C_{D-1}``: ``C_d`` has shape
``(n_nodes[d+1], n_nodes[d])`` and maps each child node at level d+1 to its
one parent at level d.  ``C_{D-1}`` maps labels to leaf clusters and ``C_0``
maps the top level to the root.  A chain is saved as ``config.json`` +
``C{d}.npz``, the layout the JAX package writes, so a chain saved by one
package loads in the other.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as smat

from . import smat_util


def padded_children(C: smat.spmatrix, pad_child: int = -1) -> Tuple[np.ndarray, int]:
    """Children table of a cluster matrix C (n_children, n_parents):
    ``(n_parents, max_children)`` int32, entry [p, j] the j-th child of parent
    p in ascending id order, ``pad_child`` where p has fewer children."""
    C = C.tocsc()
    C.sort_indices()
    n_parents = C.shape[1]
    counts = np.diff(C.indptr)
    max_c = int(counts.max()) if n_parents else 0
    table = np.full((n_parents, max_c), pad_child, dtype=np.int32)
    rows = np.repeat(np.arange(n_parents), counts)
    offs = np.arange(C.nnz) - np.repeat(C.indptr[:-1], counts)
    table[rows, offs] = C.indices
    return table, max_c


class ClusterChain(object):
    """Validated list of child->parent assignment matrices (CSC float32)."""

    def __init__(self, chain):
        if isinstance(chain, ClusterChain):
            chain = chain.chain
        if smat.issparse(chain):
            chain = [chain]
        chain = [smat.csc_matrix(C, dtype=np.float32) for C in chain]
        if not chain:
            raise ValueError("empty cluster chain")
        for d in range(1, len(chain)):
            if chain[d].shape[1] != chain[d - 1].shape[0]:
                raise ValueError(
                    f"chain[{d}].shape[1]={chain[d].shape[1]} != chain[{d-1}].shape[0]={chain[d-1].shape[0]}"
                )
        for d, C in enumerate(chain):
            if (np.diff(C.tocsr().indptr) != 1).any():
                raise ValueError(f"chain[{d}] must have exactly one parent per child")
        self.chain: List[smat.csc_matrix] = chain

    def __len__(self) -> int:
        return len(self.chain)

    def __getitem__(self, d):
        return self.chain[d]

    def __iter__(self):
        return iter(self.chain)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, ClusterChain)
            and len(self) == len(other)
            and all(A.shape == B.shape and (A != B).nnz == 0 for A, B in zip(self.chain, other.chain))
        )

    @property
    def nr_labels(self) -> int:
        return self.chain[-1].shape[0]

    @classmethod
    def from_partial_chain(cls, C, min_codes: Optional[int] = None, nr_splits: int = 16) -> "ClusterChain":
        """A full chain from a label->cluster matrix (or a chain, list or tuple
        whose top is completed): parents are grouped ``nr_splits`` at a time,
        in id order, until the top level has at most ``min_codes`` nodes
        (default ``nr_splits``), and a root above it if it has more than one."""
        if isinstance(C, (ClusterChain, list, tuple)):
            chain = list(C.chain if isinstance(C, ClusterChain) else C)
        else:
            chain = [smat.csc_matrix(C, dtype=np.float32)]
        cur = chain[0].shape[1]
        min_codes = nr_splits if min_codes is None else min_codes
        if min_codes <= 1:
            min_codes = cur
        while cur > min_codes:
            n_parent = -(-cur // nr_splits)
            chain.insert(0, cls.from_codes(np.arange(cur) // nr_splits, n_parent))
            cur = n_parent
        if cur > 1:
            chain.insert(0, smat.csc_matrix(np.ones((cur, 1), dtype=np.float32)))
        return cls(chain)

    @classmethod
    def from_codes(cls, codes: np.ndarray, n_clusters: int) -> smat.csc_matrix:
        """One-hot (n_elements, n_clusters) CSC of a flat assignment array."""
        n = len(codes)
        return smat.csc_matrix((np.ones(n, dtype=np.float32), (np.arange(n), codes)), shape=(n, n_clusters))

    def save(self, folder: str) -> None:
        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, "config.json"), "w") as f:
            json.dump({"len": len(self.chain)}, f)
        for d, C in enumerate(self.chain):
            smat_util.save_matrix(os.path.join(folder, f"C{d}.npz"), C)

    @classmethod
    def load(cls, folder: str) -> "ClusterChain":
        with open(os.path.join(folder, "config.json")) as f:
            n = json.load(f)["len"]
        return cls([smat_util.load_matrix(os.path.join(folder, f"C{d}.npz")) for d in range(n)])

    def _check_partial_dict(self, M_dict: Dict[int, Optional[smat.spmatrix]]) -> Tuple[int, int]:
        """(nr instances, nr labels) of a partial chain dict keyed by levels
        above the leaf (0 = the labels); raises ValueError on a bad key or shape."""
        nr_labels = self.nr_labels
        if not set(M_dict) <= set(range(len(self) + 1)):
            raise ValueError("partial chain dict got invalid key")
        nr_insts = {v.shape[0] for v in M_dict.values() if v is not None}
        if len(nr_insts) > 1:
            raise ValueError("partial chain dict first dims do not match")
        if M_dict.get(0) is not None and M_dict[0].shape[1] != nr_labels:
            raise ValueError("level-0 matrix must have nr_labels columns")
        for i in range(1, len(self) + 1):
            if M_dict.get(i) is not None and M_dict[i].shape[1] != self.chain[-i].shape[1]:
                raise ValueError(f"level-{i} matrix has wrong column count")
        return nr_insts.pop(), nr_labels

    def generate_matching_chain(self, M_dict) -> List[Optional[smat.csc_matrix]]:
        """User-supplied negatives per training layer from a partial dict keyed
        by levels above the leaf: each level's matrix is rolled up the chain
        and OR-ed (binarized sum) with the one given at the level above.
        ``out[t]`` has ``C_t.shape[1]`` columns; all None without input."""
        if M_dict is None or all(v is None for v in M_dict.values()):
            return [None] * len(self)
        nr_insts, nr_labels = self._check_partial_dict(M_dict)
        cur = (
            smat_util.binarized(M_dict[0])
            if M_dict.get(0) is not None
            else smat.csc_matrix((nr_insts, nr_labels), dtype=np.float32)
        )
        out = []
        for i in range(1, len(self) + 1):
            cur = (cur @ self.chain[-i]).tocsc()
            if M_dict.get(i) is not None:
                cur = (cur + smat_util.binarized(M_dict[i])).tocsc()
            cur.sort_indices()
            out.append(cur)
        return out[::-1]

    def generate_relevance_chain(self, R_dict, norm_type: Optional[str] = None, induce: bool = True) -> List[Optional[smat.spmatrix]]:
        """Relevance per training layer from a partial dict keyed by levels
        above the leaf: a level without its own matrix takes the level below
        rolled up the chain when ``induce``.  ``out[t]`` matches Y_t's labels;
        rows are normalised by ``norm_type`` (l1/l2/max) unless it is None or
        ``no-norm``."""
        out: List[Optional[smat.spmatrix]] = [None] * (len(self) + 1)
        if R_dict is None or all(v is None for v in R_dict.values()):
            return out[1:]
        self._check_partial_dict(R_dict)
        out[0] = R_dict.get(0)
        for i in range(1, len(self) + 1):
            if R_dict.get(i) is not None:
                out[i] = R_dict[i]
            elif out[i - 1] is not None and induce:
                out[i] = (out[i - 1] @ self.chain[-i]).tocsc()
        out.reverse()
        if norm_type not in (None, "no-norm"):
            out = [None if r is None else smat_util.normalize(r.tocsr(), axis=1, norm=norm_type) for r in out]
        return out[1:]

    def padded_children(self, d: int, pad_child: int = -1) -> Tuple[np.ndarray, int]:
        """Children table of level d's matrix (see the module-level
        :func:`padded_children`)."""
        return padded_children(self.chain[d], pad_child)

    def parents_of(self, d: int) -> np.ndarray:
        """Parent id of every child node of level d's matrix, int32 (n_children,)."""
        return self.chain[d].tocsr().indices.astype(np.int32)
