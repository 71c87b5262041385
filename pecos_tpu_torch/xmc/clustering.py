"""Hierarchical balanced spherical 2-means and label embeddings, in PyTorch.

The port of ``pecos_tpu/xmc/clustering.py``.  Every node of a tree level is
split at once: one segment sum (``torch_util.segment_sum``, the same bits on
every run) forms all 2^{d+1} centers, one row-wise dot
product scores every label against its node's center difference, and one
stable sort by (node, score) gives each label its rank within its node; the
upper half by rank goes to the right child.  With ``imbalanced_ratio`` > 0 a
split may move off the median to the widest score gap within ±ratio·n.

The random draws of a level (a direction per node for the first split, and
the sample mask of the center updates) come from a ``torch.Generator`` on the
device, so they differ from ``jax.random``'s.  :func:`_level_draws` makes them
and :func:`_level_split` takes them as tensors, so a test can feed the JAX
package's own draws through the port.
"""

from __future__ import annotations

import dataclasses as dc
import logging
import math
from typing import Optional, Tuple, Union

import numpy as np
import scipy.sparse as smat
import torch

import pecos_tpu_torch
from pecos_tpu_torch.utils import smat_util
from pecos_tpu_torch.utils.cluster_util import ClusterChain
from pecos_tpu_torch.utils.torch_util import DeviceLike, make_generator, resolve_device, segment_sum

LOGGER = logging.getLogger(__name__)


def _sort_key(codes: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
    """int64 keys ordering (node, score) lexicographically, one stable sort
    in place of ``lax.sort``'s two keys.  A score's key is its float bits
    with negative values' magnitude bits flipped, offset to be non-negative;
    -0.0 counts as +0.0 and every NaN as one NaN after all numbers, as
    ``lax.sort`` compares them."""
    score = torch.where(score == 0, 0.0, torch.where(torch.isnan(score), math.nan, score))
    bits = score.contiguous().view(torch.int32).long()
    total = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits) + (1 << 31)
    return codes.long() * (1 << 32) + total


def _balanced_side(codes: torch.Tensor, score: torch.Tensor, counts: torch.Tensor, ratio: float, n_nodes: int) -> torch.Tensor:
    """Side (0 left, 1 right) of every label: within its node, ranks at or
    above the boundary go right.  The boundary is ceil(n/2), or with
    ``ratio`` > 0 the first rank at the widest score gap whose rank lies in
    [max(ceil((0.5-ratio)n), 1), min(floor((0.5+ratio)n), n-1)]."""
    L = codes.shape[0]
    order = torch.sort(_sort_key(codes, score), stable=True).indices
    s_codes, s_score = codes[order], score[order]
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(L, dtype=torch.float32, device=codes.device) - starts[s_codes]
    n = counts[s_codes]
    boundary = torch.ceil(0.5 * n)
    if ratio > 0:
        r = torch.tensor(ratio, dtype=torch.float32, device=codes.device)  # window bounds in float32, as JAX rounds them
        lo = torch.clamp(torch.ceil((0.5 - r) * n), min=1.0)
        hi = torch.minimum(torch.floor((0.5 + r) * n), n - 1.0)
        same_node = torch.cat([s_codes.new_zeros(1, dtype=torch.bool), s_codes[1:] == s_codes[:-1]])
        gap = torch.cat([s_score.new_zeros(1), s_score[1:] - s_score[:-1]])
        eligible = same_node & (rank >= lo) & (rank <= hi)
        gval = torch.where(eligible, gap, -math.inf)
        gmax = torch.full((n_nodes,), -math.inf, device=codes.device).scatter_reduce(0, s_codes, gval, "amax")
        is_best = eligible & (gval >= gmax[s_codes])
        first = torch.full((n_nodes,), float(L + 1), device=codes.device).scatter_reduce(
            0, s_codes, torch.where(is_best, rank, float(L + 1)), "amin"
        )
        node_boundary = torch.where(torch.isfinite(gmax) & (first <= L), first, 0.0)[s_codes]
        boundary = torch.where(node_boundary > 0, node_boundary, boundary)
    side = torch.empty(L, dtype=torch.int64, device=codes.device)
    side[order] = (rank >= boundary).long()
    return side


def _level_draws(n_nodes: int, L: int, D: int, sample_rate: float, gen: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """One level's random draws on ``gen``'s device: a gaussian direction per
    node (n_nodes, D), and the sample weights (L,), 1 for a label that forms
    the centers (with probability ``sample_rate``), else 0."""
    dirs = torch.randn((n_nodes, D), generator=gen, device=gen.device)
    w_sample = (torch.rand((L,), generator=gen, device=gen.device) < sample_rate).float()
    return dirs, w_sample


def _level_split(
    feats: torch.Tensor,  # (L, D) float32
    codes: torch.Tensor,  # (L,) int64 node ids in [0, n_nodes)
    dirs: torch.Tensor,  # (n_nodes, D) float32
    w_sample: torch.Tensor,  # (L,) float32 in {0, 1}
    imbalanced_ratio: float,
    *,
    n_nodes: int,
    n_iter: int,
    spherical: bool,
) -> torch.Tensor:
    """Split every node into two balanced halves; returns the codes of the
    next level, 2 * node + side.  The first split is along the node's random
    direction, then ``n_iter`` rounds of 2-means re-split along the difference
    of the two (sampled, with ``spherical`` unit-norm) centers."""
    L = feats.shape[0]
    counts = torch.zeros(n_nodes, dtype=torch.float32, device=feats.device).index_add_(
        0, codes, torch.ones(L, dtype=torch.float32, device=feats.device)
    )
    ratio = min(max(float(imbalanced_ratio), 0.0), 0.49)
    side = _balanced_side(codes, (feats * dirs[codes]).sum(dim=1), counts, ratio, n_nodes)
    # each label's sampled row with its weight last, so one sum gives a center's sum and count
    weighted = torch.cat([feats * w_sample[:, None], w_sample[:, None]], dim=1)
    for _ in range(n_iter):
        # deterministic on the card, where index_add_'s float atomics are not
        sums = segment_sum(codes * 2 + side, weighted, 2 * n_nodes)
        centers = sums[:, :-1] / torch.clamp(sums[:, -1], min=1.0)[:, None]
        if spherical:
            centers = centers / torch.clamp(torch.linalg.vector_norm(centers, dim=1, keepdim=True), min=1e-12)
        diff = centers[1::2] - centers[0::2]
        side = _balanced_side(codes, (feats * diff[codes]).sum(dim=1), counts, ratio, n_nodes)
    return codes * 2 + side


def hierarchical_balanced_kmeans(
    feats: np.ndarray,
    depth: int,
    *,
    max_iter: int = 20,
    spherical: bool = True,
    seed: int = 0,
    sample_rates: Optional[np.ndarray] = None,
    imbalanced_ratio: float = 0.0,
    imbalanced_depth: int = 100,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """``depth`` levels of balanced binary (spherical) k-means on ``device``;
    returns leaf codes in [0, 2**depth).  With imbalanced_ratio=0 the sizes
    of the nodes of one level differ by at most 1; otherwise levels shallower
    than ``imbalanced_depth`` may split up to ±ratio off the median."""
    dev = resolve_device(device)
    feats_d = torch.as_tensor(np.ascontiguousarray(feats, dtype=np.float32)).to(dev)
    L, D = feats_d.shape
    codes = torch.zeros(L, dtype=torch.int64, device=dev)
    gen = make_generator(seed, dev)
    n_nodes = 2 ** max(depth - 1, 0)  # one segment space for every level, as in the JAX package
    for d in range(depth):
        rate = 1.0 if sample_rates is None else float(sample_rates[d])
        dirs, w_sample = _level_draws(n_nodes, L, D, rate, gen)
        ratio = imbalanced_ratio if d < imbalanced_depth else 0.0
        codes = _level_split(feats_d, codes, dirs, w_sample, ratio, n_nodes=n_nodes, n_iter=max_iter, spherical=spherical)
    return codes.cpu().numpy().astype(np.int32)


def sample_schedule(depth: int, do_sample: bool, min_rate: float, max_rate: float, warmup_ratio: float):
    """Per-level center sampling rates: ``min_rate`` over the first
    ``warmup_ratio`` of the levels, then a linear ramp to ``max_rate`` at the
    last level; None without sampling."""
    if not do_sample:
        return None
    warmup = int(math.ceil(warmup_ratio * depth))
    t = (np.arange(depth) - warmup) / max(depth - warmup - 1, 1)
    rates = np.where(np.arange(depth) < warmup, min_rate, min_rate + t * (max_rate - min_rate))
    return np.clip(rates, 0.0, 1.0)


def random_project(feat_mat, proj_dim: int, seed: int = 0, block: int = 65536) -> np.ndarray:
    """Seeded gaussian sketch of (dense or sparse) features to ``proj_dim``
    dims, rows L2-normalised.  The projection is drawn from numpy's
    ``default_rng(seed)`` block by block over the features (at most
    (block, proj_dim) at once), the same draws as the JAX package's."""
    L, D = feat_mat.shape
    rng = np.random.default_rng(seed)
    A = feat_mat.tocsc() if smat.issparse(feat_mat) else np.asarray(feat_mat, np.float32)
    out = np.zeros((L, proj_dim), np.float32)
    scale = 1.0 / np.sqrt(proj_dim)
    for s in range(0, D, block):
        e = min(s + block, D)
        R = (rng.standard_normal((e - s, proj_dim)) * scale).astype(np.float32)
        out += np.asarray(A[:, s:e] @ R, np.float32)
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    norms[norms == 0] = 1.0
    return out / norms


class HierarchicalKMeans(pecos_tpu_torch.BaseClass):
    """B-ary hierarchical clustering: a balanced binary tree down to
    ``max_leaf_size`` labels a leaf, whose upper levels are grouped
    ``nr_splits`` at a time."""

    @dc.dataclass
    class TrainParams(pecos_tpu_torch.BaseParams):
        nr_splits: int = 16
        min_codes: Optional[int] = None
        max_leaf_size: int = 100
        # label features wider than this are sketched to proj_dim dims by a
        # seeded gaussian projection before clustering
        max_cluster_feature_dim: int = 100_000
        proj_dim: int = 512
        imbalanced_ratio: float = 0.0
        imbalanced_depth: int = 100
        spherical: bool = True
        seed: int = 0
        kmeans_max_iter: int = 20
        threads: int = -1  # read by the reference's CPU clustering; kept for params files
        do_sample: bool = False
        max_sample_rate: float = 1.0
        min_sample_rate: float = 0.1
        warmup_ratio: float = 0.4
        verbose: int = 0

    @classmethod
    def gen(
        cls,
        feat_mat: Union[np.ndarray, smat.spmatrix],
        train_params: Optional["HierarchicalKMeans.TrainParams"] = None,
        device: DeviceLike = "cuda",
        **kwargs,
    ) -> ClusterChain:
        """The cluster chain of the labels whose features are ``feat_mat``'s
        rows, clustered on ``device``; kwargs override train_params fields."""
        params = cls.TrainParams.from_dict(train_params)
        params.override_with_kwargs(kwargs)
        if params.nr_splits < 2:
            raise ValueError(f"nr_splits must be >= 2, got {params.nr_splits}")
        nr_labels, D = feat_mat.shape
        if nr_labels <= params.max_leaf_size:
            return ClusterChain([smat.csc_matrix(np.ones((nr_labels, 1), dtype=np.float32))])
        depth = max(1, int(math.ceil(math.log2(nr_labels / params.max_leaf_size))))
        if 2**depth > nr_labels:
            depth = int(math.floor(math.log2(nr_labels)))
        if D > params.max_cluster_feature_dim:
            LOGGER.info(f"projecting label features {D} -> {params.proj_dim} dims for clustering")
            feats = random_project(feat_mat, params.proj_dim, seed=params.seed)
        else:
            feats = feat_mat.toarray() if smat.issparse(feat_mat) else feat_mat
        rates = sample_schedule(depth, params.do_sample, params.min_sample_rate, params.max_sample_rate, params.warmup_ratio)
        codes = hierarchical_balanced_kmeans(
            feats, depth, max_iter=params.kmeans_max_iter, spherical=params.spherical, seed=params.seed,
            sample_rates=rates, imbalanced_ratio=params.imbalanced_ratio,
            imbalanced_depth=params.imbalanced_depth, device=device,
        )
        return ClusterChain.from_partial_chain(
            ClusterChain.from_codes(codes, 2**depth),
            min_codes=params.min_codes if params.min_codes is not None else params.nr_splits,
            nr_splits=params.nr_splits,
        )


class Indexer(pecos_tpu_torch.BaseClass):
    """Indexers by name: ``hierarchicalkmeans``."""

    indexer_dict = {"hierarchicalkmeans": HierarchicalKMeans}

    @classmethod
    def gen(cls, feat_mat, indexer_type: str = "hierarchicalkmeans", **kwargs) -> ClusterChain:
        if indexer_type not in cls.indexer_dict:
            raise ValueError(f"unknown indexer type {indexer_type!r}")
        return cls.indexer_dict[indexer_type].gen(feat_mat, **kwargs)


class LabelEmbeddingFactory(object):
    """Label features for the indexer, from the training data (host scipy)."""

    @staticmethod
    def create(Y=None, X=None, Z=None, method: str = "pifa", **kwargs):
        method = method.lower()
        if method == "pifa":
            return LabelEmbeddingFactory.pifa(Y, X)
        if method == "pifa_lf_concat":
            return LabelEmbeddingFactory.pifa_lf_concat(Y, X, Z)
        if method == "pifa_lf_convex_combine":
            return LabelEmbeddingFactory.pifa_lf_convex_combine(Y, X, Z, alpha=kwargs.get("alpha", 0.5))
        if method == "pii":
            return LabelEmbeddingFactory.pii(Y)
        raise ValueError(f"unknown label embedding method {method!r}")

    @staticmethod
    def _transposed(Y) -> smat.csr_matrix:
        return Y.T.tocsr() if smat.issparse(Y) else smat.csr_matrix(np.asarray(Y).T)

    @staticmethod
    def pifa(Y, X):
        """Positive Instance Feature Aggregation: the L2-normalised rows of Y^T X."""
        return smat_util.normalize(LabelEmbeddingFactory._transposed(Y) @ X, axis=1, norm="l2")

    @staticmethod
    def pifa_lf_concat(Y, X, Z):
        pifa = LabelEmbeddingFactory.pifa(Y, X)
        Zn = smat_util.normalize(Z, axis=1, norm="l2")
        if smat.issparse(pifa) or smat.issparse(Zn):
            return smat_util.hstack_csr([pifa, Zn])
        return np.hstack([pifa, Zn])

    @staticmethod
    def pifa_lf_convex_combine(Y, X, Z, alpha: float = 0.5):
        pifa = LabelEmbeddingFactory.pifa(Y, X)
        Zn = smat_util.normalize(Z, axis=1, norm="l2")
        pifa = pifa.toarray() if smat.issparse(pifa) else pifa
        Zn = Zn.toarray() if smat.issparse(Zn) else Zn
        if pifa.shape[1] != Zn.shape[1]:
            raise ValueError("pifa_lf_convex_combine requires matching feature dims")
        return alpha * pifa + (1.0 - alpha) * Zn

    @staticmethod
    def pii(Y):
        """Positive Instance Indices: the L2-normalised rows of Y^T."""
        return smat_util.normalize(LabelEmbeddingFactory._transposed(Y), axis=1, norm="l2")
