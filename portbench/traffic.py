"""The benchmark's one traffic generator, driven by the mix files in ``traffic/``.

Everything is drawn from the run's ``--seed``, on the run's device, with a
``torch.Generator`` of its own for each purpose, so one seed gives the same
inputs on every run on the same kind of device.

- Query lengths are a fixed set of quantiles of the mix's distribution, the
  same set for every seed: only their order depends on the seed.  So every
  seed asks for the same work, in another order, and the padding a block
  needs (set by its longest row) varies little from seed to seed.
- Feature ids follow one Zipf popularity over a seeded permutation of the
  features (``Popularity``), distinct within a row.  The model's weights draw
  from the same popularity, so queries and weights really intersect.
- Topics (``Topics``): each internal node of the label tree owns a group of
  features of its own.  A query is about one leaf cluster, drawn uniformly:
  a share of its nonzeros comes from the groups of that cluster's path, the
  rest from the Zipf popularity; the nodes on the path weigh their group's
  features positively.  So a query's beam follows its own topic down the
  tree, and the queries of a batch reach as many leaf clusters as beams
  drawn uniformly would, as real queries about many subjects do.
- Query values are TF-IDF values: (0.5 + U[0, 1)) times the feature's idf
  under the popularity, each row scaled to unit L2 norm.
- Arrivals of an open loop are a fixed set of quantiles of the exponential
  inter-arrival law, in an order drawn from the seed.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import scipy.sparse as smat
import torch

SEED_TAGS = ("weights", "tree", "queries", "order", "arrivals", "sample", "topics")


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose, from the run's seed and a tag."""
    entropy = [int(seed) & 0xFFFFFFFFFFFFFFFF, int(seed) >> 64, SEED_TAGS.index(tag)]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]) >> 1


def generator(seed: int, tag: str, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, tag))
    return g


def quantile_lengths(n: int, spec: Dict, mean_nnz: float) -> np.ndarray:
    """``n`` row lengths: the (i + 1/2) / n quantiles of the mix's law,
    rounded and clipped to [min, max].  ``spec``:

    - ``{"law": "lognormal", "sigma": s, "min": a, "max": b}``, with mean
      ``spec.get("mean", mean_nnz)`` before clipping;
    - ``{"law": "uniform", "min": a, "max": b}``, integers a..b inclusive.
    """
    u = (np.arange(n, dtype=np.float64) + 0.5) / max(n, 1)
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["law"] == "lognormal":
        from scipy.special import ndtri

        sigma = float(spec["sigma"])
        mu = math.log(float(spec.get("mean", mean_nnz))) - sigma * sigma / 2
        raw = np.exp(mu + sigma * ndtri(u))
    elif spec["law"] == "uniform":
        raw = lo + u * (hi - lo + 1) - 0.5
    else:
        raise ValueError(f"unknown length law {spec['law']!r}")
    return np.clip(np.rint(raw), lo, hi).astype(np.int64)


def permuted(values: np.ndarray, seed: int, tag: str) -> np.ndarray:
    """``values`` in an order drawn from the seed."""
    return values[np.random.default_rng(sub_seed(seed, tag)).permutation(len(values))]


class Popularity:
    """Zipf(s) popularity over a seeded permutation of D features: the
    feature of popularity rank r (0 the most popular) is ``perm[r]``, drawn
    with probability ``p[r]`` proportional to 1 / (r + 1)^s."""

    def __init__(self, D: int, s: float, gen: torch.Generator, device: torch.device):
        self.D = D
        self.perm = torch.randperm(D, generator=gen, device=device)
        self.rank_of = torch.empty_like(self.perm)
        self.rank_of[self.perm] = torch.arange(D, device=device)
        w = torch.arange(1, D + 1, dtype=torch.float64, device=device).pow(-float(s))
        self.p = w / w.sum()
        self.cdf = torch.cumsum(self.p, 0)

    def ranks(self, n: int, gen: torch.Generator) -> torch.Tensor:
        u = torch.rand(n, generator=gen, dtype=torch.float64, device=self.cdf.device)
        return torch.searchsorted(self.cdf, u, right=True).clamp_(max=self.D - 1)

    def idf(self, ids: torch.Tensor, mean_nnz: float) -> torch.Tensor:
        """1 + ln(1 / df) of feature ids, with df = 1 - (1 - p)^m the share of
        rows of ``mean_nnz`` draws that hold the feature (smoothed idf)."""
        p = self.p[self.rank_of[ids]]
        df = -torch.expm1(float(mean_nnz) * torch.log1p(-p))
        return 1.0 - torch.log(df)


class Topics:
    """Disjoint groups of ``size`` features, one for each of ``n_groups``
    nodes, from a seeded permutation of the D features (so a group's
    features have any popularity, most of them rare)."""

    def __init__(self, n_groups: int, size: int, D: int, gen: torch.Generator, device: torch.device):
        if n_groups * size > D:
            raise ValueError(f"{n_groups} topic groups of {size} need more than the {D} features there are")
        self.size = size
        self.ids = torch.randperm(D, generator=gen, device=device)[: n_groups * size].view(n_groups, size)

    def pick(self, groups: torch.Tensor, counts: torch.Tensor, gen: torch.Generator):
        """(row, ids): for each i, ``counts[i]`` (at most ``size``) distinct
        features of group ``groups[i]``, drawn uniformly; ``row`` is i."""
        n = groups.shape[0]
        order = torch.rand((n, self.size), generator=gen, device=groups.device).argsort(dim=1)
        keep = torch.arange(self.size, device=groups.device)[None, :] < counts[:, None]
        ids = self.ids[groups].gather(1, order)
        row = torch.arange(n, device=groups.device)[:, None].expand(n, self.size)
        return row[keep], ids[keep]


def distinct_rows(counts: torch.Tensor, pop: Popularity, gen: torch.Generator, fixed=None):
    """Rows of ``counts[i]`` features drawn from ``pop``, beside the row's
    ``fixed`` features, all distinct within a row.

    ``fixed`` is (row, ids) of features given in advance (distinct within
    their row).  Draws every other slot, then draws again the slots that
    repeat a feature of their row (a fixed one, or the first occurrence,
    stays), only in rows that still repeat one, until none does.  Returns
    (indptr (n+1,), ids, is_fixed) on the device, ids sorted within each row."""
    dev = counts.device
    D = pop.D
    n = counts.shape[0]
    f_row, f_ids = fixed if fixed is not None else (torch.zeros(0, dtype=torch.int64, device=dev),) * 2
    per_row = counts + torch.bincount(f_row, minlength=n)
    if per_row.numel() and int(per_row.max()) > D:
        raise ValueError(f"a row asks for more than the {D} features there are")
    # the fixed slots first, so that a stable sort keeps them as the first occurrence
    row = torch.cat([f_row, torch.repeat_interleave(torch.arange(n, device=dev), counts)])
    n_fixed = f_row.shape[0]
    ranks = torch.cat([pop.rank_of[f_ids], pop.ranks(row.shape[0] - n_fixed, gen)])
    todo = torch.arange(row.shape[0], device=dev)
    while todo.numel():
        key = row[todo] * D + ranks[todo]
        skey, order = torch.sort(key, stable=True)
        dup = todo[order[1:][skey[1:] == skey[:-1]]]
        if not dup.numel():
            break
        ranks[dup] = pop.ranks(dup.numel(), gen)
        again = torch.zeros(n, dtype=torch.bool, device=dev)
        again[row[dup]] = True
        todo = torch.nonzero(again[row]).squeeze(1)
    key, order = torch.sort(row * D + pop.perm[ranks])
    ids = key - row[order] * D
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(per_row, 0)
    return indptr, ids, order < n_fixed


def query_pool(n: int, lengths: np.ndarray, model, seed: int, device) -> smat.csr_matrix:
    """(n, D) float32 CSR of queries with the given row lengths, in that
    order.  Each query is about one leaf cluster of ``model``'s tree, drawn
    uniformly: ``round(query_share * length)`` of its nonzeros come from the
    topic groups of the cluster's path (``model.paths``, one group a level,
    spread evenly, the deeper levels first), the rest from the popularity.
    Values are TF-IDF values at unit L2 norm (positive)."""
    gen = generator(seed, "queries", device)
    pop, topics, paths = model.popularity, model.topics, model.paths
    counts = torch.as_tensor(lengths[:n], device=device)
    T = paths.shape[1]
    target = torch.randint(0, paths.shape[0], (n,), generator=gen, device=device)
    n_topic = torch.round(counts.double() * float(model.query_share)).long()
    level = torch.arange(T, device=device)
    per_level = n_topic[:, None] // T + (level[None, :] >= T - n_topic[:, None] % T).long()
    per_level = per_level.clamp(max=topics.size)
    f_row, f_ids = topics.pick(paths[target].reshape(-1), per_level.reshape(-1), gen)
    indptr, ids, _ = distinct_rows(counts - per_level.sum(1), pop, gen, fixed=(f_row // T, f_ids))
    vals = (torch.rand(ids.shape[0], generator=gen, device=device, dtype=torch.float64) + 0.5) * pop.idf(
        ids, model.mean_nnz
    )
    row = torch.repeat_interleave(torch.arange(n, device=device), counts)
    norm = torch.zeros(n, dtype=torch.float64, device=device).index_add_(0, row, vals * vals).sqrt()
    vals = (vals / norm[row]).float()
    return smat.csr_matrix(
        (vals.cpu().numpy(), ids.to(torch.int32).cpu().numpy(), indptr.cpu().numpy()), shape=(n, pop.D)
    )


def arrival_times(n: int, seconds: float, seed: int) -> np.ndarray:
    """Due times in [0, seconds) of n Poisson arrivals, ascending: the
    exponential gaps are a fixed set of quantiles, in an order drawn from
    the seed, scaled so that they fill the window."""
    u = (np.arange(n, dtype=np.float64) + 0.5) / max(n, 1)
    gaps = permuted(-np.log1p(-u), seed, "arrivals")
    t = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return t * (seconds / max(gaps.sum(), 1e-12))


def block_bounds(n: int, block: int):
    """(start, stop) of consecutive blocks of ``block`` rows over n rows."""
    return [(s, min(s + block, n)) for s in range(0, n, block)]
