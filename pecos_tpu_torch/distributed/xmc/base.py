"""Distributed (meta-tree / sub-tree partitioned) clustering.

The port of ``pecos_tpu/distributed/xmc/base.py``.  Rank 0 builds a small meta
tree over all labels; its leaves cut the labels into subtrees; every rank
clusters the subtrees it is given, and rank 0 assembles the chains into one
``ClusterChain``: the meta tree's levels on top, the subtrees' levels
block-diagonal below, the bottom level's rows mapped back to the original
label ids.  Host objects travel through a ``DistComm``; each rank's
``Indexer.gen`` runs on its own device with its own seeded generator.
"""

from __future__ import annotations

import dataclasses as dc
import logging
import math
from typing import List, Optional

import numpy as np
import scipy.sparse as smat

import pecos_tpu_torch
from pecos_tpu_torch.parallel.comm import DistComm
from pecos_tpu_torch.utils import smat_util
from pecos_tpu_torch.utils.cluster_util import ClusterChain
from pecos_tpu_torch.utils.torch_util import DeviceLike
from pecos_tpu_torch.xmc import HierarchicalKMeans, Indexer, LabelEmbeddingFactory

LOGGER = logging.getLogger(__name__)


def csc_col_nonzero(M: smat.spmatrix) -> List[np.ndarray]:
    """Each column's nonzero row indices, sorted."""
    M = M.tocsc()
    return [np.sort(M.indices[M.indptr[c] : M.indptr[c + 1]]) for c in range(M.shape[1])]


class DistClusterChain(object):
    """A full cluster chain and the depth at which the meta tree ends and the
    subtrees begin."""

    def __init__(self, cluster_chain, split_depth: int):
        chain = ClusterChain(cluster_chain)
        if len(chain) < 2:
            raise ValueError("cluster chain needs >= 2 layers to split")
        if not 1 <= split_depth < len(chain):
            raise ValueError(f"bad split_depth {split_depth}")
        self._chain = chain
        self._split_depth = split_depth
        self._meta_leaf = None

    def get_cluster_chain(self) -> ClusterChain:
        return self._chain

    def get_split_depth(self) -> int:
        return self._split_depth

    def get_num_sub_tree(self) -> int:
        return self._chain[self._split_depth].shape[1]

    def get_nr_splits(self) -> int:
        if len(self._chain) <= 2:
            return self._chain[0].shape[0]
        return self._chain[1].shape[0] // self._chain[0].shape[0]

    def get_avg_leaf_size(self) -> int:
        return max(1, self._chain[-1].shape[0] // self._chain[-2].shape[0])

    def get_meta_tree_chain(self) -> ClusterChain:
        return ClusterChain(self._chain[: self._split_depth])

    def get_meta_tree_leaf_cluster(self) -> smat.csc_matrix:
        """The label -> subtree matrix: the levels below the split composed."""
        if self._meta_leaf is None:
            M = self._chain[-1]
            for d in range(len(self._chain) - 2, self._split_depth - 1, -1):
                M = M @ self._chain[d]
            self._meta_leaf = M.tocsc()
        return self._meta_leaf

    def get_sub_tree_assignment(self, sub_tree_idx: Optional[int] = None):
        """Every subtree's labels (a list), or subtree ``sub_tree_idx``'s."""
        assignments = csc_col_nonzero(self.get_meta_tree_leaf_cluster())
        return assignments if sub_tree_idx is None else assignments[sub_tree_idx]

    def get_sub_tree_chain(self, sub_tree_idx: int) -> ClusterChain:
        """Subtree ``sub_tree_idx``'s own chain: the bottom level cut to its
        labels and their clusters, completed upward by ``from_partial_chain``
        (its clusters are contiguous, so grouping by nr_splits gives back the
        original levels)."""
        nr_splits = self.get_nr_splits()
        sub = self._chain[-1].tocsr()[self.get_sub_tree_assignment(sub_tree_idx), :]
        sub = sub.tocsc()[:, np.unique(sub.indices)]
        return ClusterChain.from_partial_chain(sub, min_codes=nr_splits, nr_splits=nr_splits)

    def get_meta_Y(self, Y: smat.spmatrix) -> smat.csc_matrix:
        return (Y @ self.get_meta_tree_leaf_cluster()).tocsc()

    def new_instance_re_split(self, min_n_sub_tree: int) -> "DistClusterChain":
        """The same chain split at the first level with at least ``min_n_sub_tree`` clusters."""
        if self._chain[-1].shape[1] < min_n_sub_tree:
            raise ValueError("not enough clusters to split")
        d = next(d for d in range(1, len(self._chain)) if self._chain[d].shape[1] >= min_n_sub_tree)
        return DistClusterChain(self._chain, d)

    @classmethod
    def assemble_from_meta_sub_chain(cls, meta_chain: ClusterChain, sub_chains: List[ClusterChain]) -> "DistClusterChain":
        """One chain from a meta chain (whose last level is label -> subtree)
        and the subtrees' chains, all of one depth: the meta levels, then each
        subtree level block-diagonal, the bottom one's rows mapped back to the
        original label ids."""
        depth = len(sub_chains[0])
        if any(len(s) != depth for s in sub_chains):
            raise ValueError("all sub chains must share depth")
        chain = list(meta_chain)[:-1]
        split_depth = len(chain)
        assignment = np.concatenate(csc_col_nonzero(meta_chain[-1]))
        for d in range(depth):
            layer = smat_util.block_diag_csc([s[d] for s in sub_chains])
            if d == depth - 1:
                layer = smat.csc_matrix((layer.data, assignment[layer.indices], layer.indptr), shape=layer.shape)
            chain.append(layer)
        return cls(ClusterChain(chain), split_depth)

    @classmethod
    def broadcast(cls, comm: DistComm, dist_chain: Optional["DistClusterChain"], root: int = 0) -> "DistClusterChain":
        """Root's chain on every rank."""
        is_root = comm.get_rank() == root
        split_depth = comm.bcast(dist_chain.get_split_depth() if is_root else None, root=root)
        chain = comm.bcast(dist_chain.get_cluster_chain() if is_root else None, root=root)
        return cls(chain, split_depth)


def _pad_chain_to_depth(chain: ClusterChain, depth: int) -> ClusterChain:
    """Identity levels put on top of ``chain`` until it is ``depth`` deep."""
    mats = list(chain)
    while len(mats) < depth:
        mats.insert(0, smat.identity(mats[0].shape[1], dtype=np.float32, format="csc"))
    return ClusterChain(mats)


class DistClustering(pecos_tpu_torch.BaseClass):
    """Distributed hierarchical clustering."""

    @dc.dataclass
    class ClusterParams(pecos_tpu_torch.BaseParams):
        indexer_params: Optional[HierarchicalKMeans.TrainParams] = None
        meta_label_embedding_method: str = "pifa"
        sub_label_embedding_method: str = "pifa"

    @classmethod
    def dist_get_cluster_chain(
        cls,
        X,
        Y,
        dist_comm: DistComm,
        cluster_params: Optional["DistClustering.ClusterParams"] = None,
        min_n_sub_tree: Optional[int] = None,
        device: DeviceLike = "cuda",
    ) -> DistClusterChain:
        """The distributed chain of Y's labels, the same on every rank.

        Rank 0 clusters all labels into at least ``min_n_sub_tree`` (default:
        the number of ranks) subtrees, a power of nr_splits; subtree t is
        clustered by rank t mod size on ``device``; rank 0 assembles and
        broadcasts the result."""
        params = cls.ClusterParams.from_dict(cluster_params)
        indexer_params = HierarchicalKMeans.TrainParams.from_dict(params.indexer_params)
        rank, size = dist_comm.get_rank(), dist_comm.get_size()
        nr_splits = indexer_params.nr_splits

        meta_chain = None
        if rank == 0:
            n_subtrees = nr_splits
            while n_subtrees < (min_n_sub_tree or size):
                n_subtrees *= nr_splits
            meta_params = HierarchicalKMeans.TrainParams.from_dict(indexer_params.to_dict())
            meta_params.max_leaf_size = max(1, int(math.ceil(Y.shape[1] / n_subtrees)))
            feats = LabelEmbeddingFactory.create(Y, X, method=params.meta_label_embedding_method)
            meta_chain = Indexer.gen(feats, train_params=meta_params, device=device)
        meta_chain = dist_comm.bcast(meta_chain, root=0)
        assignments = csc_col_nonzero(meta_chain[-1])

        Y_csc = Y.tocsc()
        mine = {}
        for t in range(rank, len(assignments), size):
            feats = LabelEmbeddingFactory.create(Y_csc[:, assignments[t]], X, method=params.sub_label_embedding_method)
            mine[t] = Indexer.gen(feats, train_params=HierarchicalKMeans.TrainParams.from_dict(indexer_params.to_dict()), device=device)

        gathered = dist_comm.gather(mine, root=0)
        dist_chain = None
        if rank == 0:
            chains = {t: c for part in gathered for t, c in part.items()}
            depth = max(len(c) for c in chains.values())
            subs = [_pad_chain_to_depth(chains[t], depth) for t in range(len(assignments))]
            dist_chain = DistClusterChain.assemble_from_meta_sub_chain(meta_chain, subs)
        return DistClusterChain.broadcast(dist_comm, dist_chain, root=0)
