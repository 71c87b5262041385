"""XR-Linear predict: the model a configuration file with ``"model": "xrlinear"`` names.

The parts the harness drives (``portbench/README.md`` has the contract):

- ``Model``: the tree and the weights, made from the seed.  The tree follows
  ``Indexer.gen``'s public rule (``nr_splits``, ``max_leaf_size``): 2^depth
  leaf clusters with depth = ceil(log2(L / max_leaf_size)), labels dealt to
  them by a balanced split of a seeded permutation (the sizes balanced
  k-means gives; no clustering is run), then parents grouped ``nr_splits``
  at a time in id order until at most ``nr_splits`` nodes are left, under one
  root.  Every node of every level holds ``weights_per_label`` weights: that
  many less one distinct features and the bias feature (id D).  Each internal
  node owns a topic group of ``topic.features`` features and weighs
  ``topic.node_slots`` of them positively (N(weight_mean, weight_std^2)); a
  label weighs ``topic.label_slots`` of its leaf cluster's group so; the
  other slots are Zipf features at N(0, weight_std^2) (the configuration's
  ``weight_std``), the bias at N(0, bias_weight_std^2).  Drawn on the device
  in one pass, kept on the host as (n, P) id and value arrays.
- ``Program``: the system under test, ``pecos_tpu_torch``'s
  ``XLinearModel``, built through its public constructor from scipy CSC
  matrices of those arrays, so the port makes its own layouts.
- the queries: ``queries`` builds a pool, a (n, D) float32 CSR matrix of
  TF-IDF rows (``traffic.query_pool``); ``row_sizes``, ``stack`` and
  ``arrays`` are the rest of what the harness asks of a pool
  (``portbench/README.md``).
- the plain reference is ``xrlinear_reference.py`` beside this file; the
  operations and bytes of the work are counted in ``xrlinear_work.py``.
"""

from __future__ import annotations

import gc
import math
from typing import Dict, List, Sequence

import numpy as np
import scipy.sparse as smat
import torch

from portbench import traffic


def tree_sizes(L: int, nr_splits: int, max_leaf_size: int) -> List[int]:
    """Nodes per level, top first, the labels last (``Indexer.gen``'s rule)."""
    if L <= max_leaf_size:
        return [L]
    depth = max(1, int(math.ceil(math.log2(L / max_leaf_size))))
    if 2**depth > L:
        depth = int(math.floor(math.log2(L)))
    sizes = [2**depth]
    while sizes[0] > nr_splits:
        sizes.insert(0, -(-sizes[0] // nr_splits))
    return sizes + [L]


def tree_parents(sizes: List[int], nr_splits: int, seed: int) -> List[np.ndarray]:
    """For each level d, the parent (a node of level d - 1; 0, the root, for
    level 0) of each of its nodes, int64.  Labels go to leaf clusters by a
    balanced split of a seeded permutation; clusters to parents by id."""
    parents = [np.zeros(sizes[0], np.int64)]
    for d in range(1, len(sizes) - 1):
        parents.append(np.arange(sizes[d], dtype=np.int64) // nr_splits)
    if len(sizes) > 1:
        L, n_leaf = sizes[-1], sizes[-2]
        order = np.random.default_rng(traffic.sub_seed(seed, "tree")).permutation(L)
        leaf = np.empty(L, np.int64)
        leaf[order] = np.arange(L, dtype=np.int64) * n_leaf // L
        parents.append(leaf)
    return parents


class Model:
    """The tree and weights of one configuration, from the seed.

    ``ids[d]`` (n_d, P) int32 and ``vals[d]`` (n_d, P) float32 hold level d's
    weights (feature ids ascending, the bias feature D last), ``parents[d]``
    each node's parent, ``sizes`` the nodes per level.  ``topics`` holds one
    feature group for each internal node (level by level), ``paths`` (leaf
    clusters, levels - 1) each leaf cluster's groups from the top down, which
    the queries draw from."""

    def __init__(self, cfg: Dict, seed: int, device: torch.device):
        self.cfg = cfg
        self.D = int(cfg["nr_features"])
        self.bias = float(cfg["bias"])
        self.mean_nnz = float(cfg["mean_query_nnz"])
        topic = cfg["topic"]
        self.query_share = float(topic["query_share"])
        self.sizes = tree_sizes(int(cfg["nr_labels"]), int(cfg["nr_splits"]), int(cfg["max_leaf_size"]))
        self.parents = tree_parents(self.sizes, int(cfg["nr_splits"]), seed)
        gen = traffic.generator(seed, "weights", device)
        self.popularity = traffic.Popularity(self.D, float(cfg["zipf_s"]), gen, device)
        inner = self.sizes[:-1]
        first = np.cumsum([0] + inner)  # each internal level's first group
        self.topics = traffic.Topics(int(first[-1]), int(topic["features"]), self.D,
                                     traffic.generator(seed, "topics", device), device)
        paths = [np.arange(inner[-1], dtype=np.int64)]
        for d in range(len(inner) - 1, 0, -1):
            paths.insert(0, self.parents[d][paths[0]])
        self.paths = torch.as_tensor(np.stack([p + first[d] for d, p in enumerate(paths)], 1), device=device)
        # each node's group and how many of its slots weigh the group
        groups = np.concatenate([np.arange(first[-1]), first[-2] + self.parents[-1]])
        slots = np.concatenate([np.full(first[-1], int(topic["node_slots"])),
                                np.full(self.sizes[-1], int(topic["label_slots"]))])
        P = int(cfg["weights_per_label"])
        total = sum(self.sizes)
        groups, slots = torch.as_tensor(groups, device=device), torch.as_tensor(slots, device=device)
        fixed = self.topics.pick(groups, slots, gen)
        _, ids, on_topic = traffic.distinct_rows(P - 1 - slots, self.popularity, gen, fixed=fixed)
        ids = torch.cat([ids.view(total, P - 1), torch.full((total, 1), self.D, dtype=torch.int64, device=device)], 1)
        on_topic = torch.cat([on_topic.view(total, P - 1), torch.zeros((total, 1), dtype=torch.bool, device=device)], 1)
        vals = torch.randn((total, P), generator=gen, device=device)
        std = float(cfg["weight_std"])
        vals = torch.where(on_topic, float(topic["weight_mean"]) + float(topic["weight_std"]) * vals, std * vals)
        vals[:, P - 1] *= float(cfg["bias_weight_std"]) / std
        ids_h, vals_h = ids.to(torch.int32).cpu().numpy(), vals.cpu().numpy()
        del ids, vals, on_topic, fixed
        bounds = np.cumsum([0] + self.sizes)
        self.ids = [ids_h[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
        self.vals = [vals_h[a:b] for a, b in zip(bounds[:-1], bounds[1:])]

    @property
    def depth(self) -> int:
        return len(self.sizes)

    def csc(self, d: int) -> smat.csc_matrix:
        """Level d's weights as the (D+1, n_d) float32 CSC a trained model holds."""
        n, P = self.ids[d].shape
        return smat.csc_matrix(
            (self.vals[d].ravel(), self.ids[d].ravel(), np.arange(0, n * P + 1, P, dtype=np.int64)),
            shape=(self.D + 1, n),
        )

    def cluster_matrix(self, d: int) -> smat.csc_matrix:
        n = self.sizes[d]
        n_par = 1 if d == 0 else self.sizes[d - 1]
        return smat.csc_matrix(
            (np.ones(n, np.float32), (np.arange(n), self.parents[d])), shape=(n, n_par)
        )


class Program:
    """The system under test: ``pecos_tpu_torch``'s XLinearModel over the
    model's matrices, on ``device``.  ``wire`` is the query wire's value type:
    "float32", as the configuration states, or "float16", the port's own
    lower-precision path that the control switches on."""

    def __init__(self, model: Model, device: torch.device, wire: str = "float32"):
        from pecos_tpu_torch.xmc import HierarchicalMLModel, MLModel
        from pecos_tpu_torch.xmc.xlinear import XLinearModel

        cfg = model.cfg
        chain = [
            MLModel(model.csc(d), model.cluster_matrix(d), bias=model.bias, device=device)
            for d in range(model.depth)
        ]
        self.xlm = XLinearModel(HierarchicalMLModel(chain))
        self.kw = dict(
            beam_size=int(cfg["beam_size"]), only_topk=int(cfg["only_topk"]),
            post_processor=cfg["post_processor"], wire_value_dtype=wire,
        )

    def predict(self, X: smat.csr_matrix) -> smat.csr_matrix:
        """``XLinearModel.predict``: the batch pipeline, in batches of its
        default 1,024 queries (``XLinearModel.predict`` passes no batch size)."""
        return self.xlm.predict(X, **self.kw)

    def session(self, batch: int, cap: int):
        """``XLinearModel.realtime_session``; its ``predict`` serves a request."""
        return self.xlm.realtime_session(**self.kw, batch=batch, cap=cap)

    def free(self) -> None:
        self.xlm = None
        gc.collect()


def queries(model: Model, n: int, lengths: np.ndarray, mix: Dict, seed: int, device) -> smat.csr_matrix:
    """The pool: n TF-IDF queries with the row lengths the loop drew, in that order."""
    return traffic.query_pool(n, lengths, model, seed, device)


def row_sizes(Q: smat.csr_matrix) -> np.ndarray:
    """Each query's nonzeros."""
    return np.diff(Q.indptr)


def stack(parts: Sequence[smat.csr_matrix]) -> smat.csr_matrix:
    return smat.vstack(parts, format="csr")


def arrays(Q: smat.csr_matrix) -> List[np.ndarray]:
    """The arrays that hold the pool, for its digest."""
    return [Q.indptr, Q.indices, Q.data]
