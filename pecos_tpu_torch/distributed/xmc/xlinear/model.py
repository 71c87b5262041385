"""Distributed XR-Linear training: the meta model on rank 0, the subtree
models spread over the ranks, one standard ``XLinearModel`` at the end.

The port of ``pecos_tpu/distributed/xmc/xlinear/model.py``:

- ``XLinearLoadBalancer``: a subtree's work is the nonzeros of its labels'
  columns of Y times log(mean leaf size); subtrees are dealt out in order,
  rank 0's share cut by ``main_workload_factor`` as it also trains the meta
  model.
- ``DistributedXLinearModel.train``: rank 0 trains the meta model on Y rolled
  up to the subtrees; every rank trains its subtrees' models, each on the
  instances that carry one of its labels; rank 0 gathers them and
  ``reconstruct`` joins them into one model.
"""

from __future__ import annotations

import dataclasses as dc
import logging
from typing import List, Optional, Sequence

import numpy as np
import scipy.sparse as smat

import pecos_tpu_torch
from pecos_tpu_torch.parallel.comm import DistComm
from pecos_tpu_torch.utils.torch_util import DeviceLike
from pecos_tpu_torch.xmc import HierarchicalMLModel, MLModel, MLProblem
from pecos_tpu_torch.xmc.xlinear import XLinearModel
from ..base import DistClusterChain, DistClustering

LOGGER = logging.getLogger(__name__)


class XLinearLoadBalancer(object):
    """Order-preserving partition of the subtrees' work onto the ranks."""

    def __init__(self, main_workload_factor: float = 0.3):
        self.main_workload_factor = main_workload_factor

    @staticmethod
    def subtree_workloads(Y: smat.spmatrix, dist_chain: DistClusterChain) -> np.ndarray:
        """Each subtree's work: nonzeros of its labels' columns of Y times log(mean leaf size)."""
        col_nnz = np.diff(Y.tocsc().indptr)
        log_leaf = max(1.0, np.log(max(2, dist_chain.get_avg_leaf_size())))
        return np.array([col_nnz[rows].sum() * log_leaf for rows in dist_chain.get_sub_tree_assignment()], dtype=np.float64)

    def partition(self, workloads: np.ndarray, n_machines: int) -> List[List[int]]:
        """Contiguous runs of subtrees, one per rank: rank m takes subtrees
        until the running total reaches the first m+1 ranks' targets (equal
        shares, rank 0's scaled by main_workload_factor)."""
        weights = np.ones(n_machines)
        weights[0] = self.main_workload_factor
        bounds = np.cumsum(workloads.sum() * weights / weights.sum())
        jobs: List[List[int]] = [[] for _ in range(n_machines)]
        m, acc = 0, 0.0
        for t, w in enumerate(workloads):
            jobs[m].append(t)
            acc += w
            while m < n_machines - 1 and acc >= bounds[m]:
                m += 1
        return jobs


class DistributedXLinearModel(pecos_tpu_torch.BaseClass):
    """Distributed trainer whose result is a standard ``XLinearModel``."""

    @dc.dataclass
    class TrainParams(pecos_tpu_torch.BaseParams):
        hlm_args: Optional[HierarchicalMLModel.TrainParams] = None
        main_workload_factor: float = 0.3
        min_n_sub_tree: Optional[int] = None

    @classmethod
    def train(
        cls,
        X,
        Y,
        dist_comm: DistComm,
        cluster_params=None,
        train_params: Optional["DistributedXLinearModel.TrainParams"] = None,
        pred_params=None,
        dist_chain: Optional[DistClusterChain] = None,
        device: DeviceLike = "cuda",
        **kwargs,
    ) -> Optional[XLinearModel]:
        """Train over ``dist_comm``'s ranks, each on ``device``; returns the
        model on rank 0 and None elsewhere.  Without ``dist_chain`` the ranks
        build one with ``DistClustering`` first."""
        params = cls.TrainParams.from_dict(train_params)
        rank, size = dist_comm.get_rank(), dist_comm.get_size()
        if dist_chain is None:
            dist_chain = DistClustering.dist_get_cluster_chain(
                X, Y, dist_comm, cluster_params, min_n_sub_tree=params.min_n_sub_tree, device=device
            )
        assignments = dist_chain.get_sub_tree_assignment()
        Y_csc = Y.tocsc()
        balancer = XLinearLoadBalancer(params.main_workload_factor)
        my_jobs = balancer.partition(balancer.subtree_workloads(Y_csc, dist_chain), size)[rank]
        train = lambda X_, Y_, chain: HierarchicalMLModel.train(
            MLProblem(X_, Y_), clustering=chain, train_params=params.hlm_args, pred_params=pred_params, device=device, **kwargs
        )

        meta_model = None
        if rank == 0:
            LOGGER.info(f"rank 0 training the meta model over {dist_chain.get_num_sub_tree()} subtrees")
            meta_model = train(X, dist_chain.get_meta_Y(Y_csc), dist_chain.get_meta_tree_chain())

        X_csr = X.tocsr() if smat.issparse(X) else smat.csr_matrix(X)
        mine = {}
        for t in my_jobs:
            Y_sub = Y_csc[:, assignments[t]].tocsr()
            inst = np.flatnonzero(np.diff(Y_sub.indptr) > 0)
            if inst.size == 0:
                inst = np.arange(min(1, Y_sub.shape[0]))
            LOGGER.info(f"rank {rank} training subtree {t} ({len(assignments[t])} labels, {len(inst)} instances)")
            mine[t] = train(X_csr[inst], Y_sub[inst].tocsc(), dist_chain.get_sub_tree_chain(t))

        gathered = dist_comm.gather(mine, root=0)
        if rank != 0:
            return None
        models = {t: m for part in gathered for t, m in part.items()}
        return cls.reconstruct(meta_model, [models[t] for t in range(len(assignments))], assignments)

    @staticmethod
    def reconstruct(
        meta_model: HierarchicalMLModel, sub_models: Sequence[HierarchicalMLModel], assignments: Sequence[np.ndarray]
    ) -> XLinearModel:
        """The meta model's layers, then each level of the subtree models
        joined (``XLinearModel.reconstruct_model``), the bottom level's labels
        put back in their original order: W's columns and C's rows."""
        joined = XLinearModel.reconstruct_model(meta_model, sub_models).model
        assignment = np.concatenate(list(assignments))
        order = np.empty_like(assignment)
        order[assignment] = np.arange(len(assignment))
        bottom = joined.model_chain[-1]
        chain = joined.model_chain[:-1] + [
            MLModel(
                W=bottom.W.tocsc()[:, order], C=bottom.C.tocsr()[order].tocsc(), bias=bottom.bias,
                pred_params=bottom.get_pred_params(), device=bottom.device,
            )
        ]
        return XLinearModel(HierarchicalMLModel(chain))
