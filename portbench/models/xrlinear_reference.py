"""The plain reference of XR-Linear predict, in float64 PyTorch.

It imports nothing of the program.  It is handed the benchmark's own arrays
(each level's (n, P) weight ids and values, each node's parent, the query
CSR) and works out the rest itself: the children tables, the query rows made
dense, every candidate's score by a gather at the weight ids, the
post-processor, the combination along the path and a stable descending sort.

- ``beam_search``: the beam search as the configuration states it (beam
  ``beam_size``, ``only_topk`` results, candidates in children-table order,
  ties broken by the lower position).  For each query it also gives the
  smallest relative margin between the last value kept and the first value
  dropped at any level: where that is below the comparison's tolerance, two
  equally right programs may keep different beams, so the labels are not
  compared there.
- ``path_values``: the value a label gets along its own path to the root,
  whatever the beam, which the program's score of the label is held to.

Only the ``l3-hinge`` post-processor is written out: transform
exp(-max(1 - v, 0)^3), combined by multiplication, from 1 at the root.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import scipy.sparse as smat
import torch

POST_PROCESSORS = ("l3-hinge",)
# bytes of float64 dense query rows a block may hold
DENSE_BLOCK_BYTES = {"cuda": 1 << 31, "cpu": 1 << 27}


def transform(v: torch.Tensor) -> torch.Tensor:
    return torch.exp(-torch.clamp(1.0 - v, min=0.0) ** 3)


def children_of(parent: np.ndarray, n_parents: int) -> np.ndarray:
    """(n_parents, max children) int64, children ascending, -1 padded."""
    parent = np.asarray(parent, np.int64)
    counts = np.bincount(parent, minlength=n_parents)
    first = np.cumsum(counts) - counts
    by_parent = np.argsort(parent, kind="stable")  # children of one parent stay ascending
    table = np.full((n_parents, int(counts.max(initial=0))), -1, np.int64)
    table[parent[by_parent], np.arange(len(parent)) - first[parent[by_parent]]] = by_parent
    return table


class Reference:
    def __init__(
        self,
        ids: Sequence[np.ndarray],
        vals: Sequence[np.ndarray],
        parents: Sequence[np.ndarray],
        D: int,
        bias: float,
        beam_size: int,
        only_topk: int,
        post_processor: str,
        device: torch.device,
    ):
        if post_processor not in POST_PROCESSORS:
            raise ValueError(f"the reference writes out {POST_PROCESSORS}, not {post_processor!r}")
        self.device = device
        self.D, self.bias = D, bias
        self.beam_size, self.only_topk = beam_size, only_topk
        self.ids = [torch.as_tensor(np.asarray(a, np.int64), device=device) for a in ids]
        self.vals = [torch.as_tensor(np.asarray(a, np.float64), device=device) for a in vals]
        self.parent = [torch.as_tensor(np.asarray(p, np.int64), device=device) for p in parents]
        sizes = [len(p) for p in parents]
        self.children = [
            torch.as_tensor(children_of(np.asarray(p), 1 if d == 0 else sizes[d - 1]), device=device)
            for d, p in enumerate(parents)
        ]
        budget = DENSE_BLOCK_BYTES.get(device.type, DENSE_BLOCK_BYTES["cpu"])
        self.block = max(1, budget // ((D + 1) * 8))

    @property
    def depth(self) -> int:
        return len(self.ids)

    def _dense(self, X: smat.csr_matrix) -> torch.Tensor:
        """(n, D+1) float64 rows on the device, the bias feature in column D."""
        n = X.shape[0]
        indptr = torch.as_tensor(X.indptr.astype(np.int64), device=self.device)
        row = torch.repeat_interleave(torch.arange(n, device=self.device), indptr[1:] - indptr[:-1])
        out = torch.zeros((n, self.D + 1), dtype=torch.float64, device=self.device)
        col = torch.as_tensor(X.indices.astype(np.int64), device=self.device)
        out.index_put_((row, col), torch.as_tensor(X.data.astype(np.float64), device=self.device), accumulate=True)
        out[:, self.D] = self.bias
        return out

    def _scores(self, Xd: torch.Tensor, d: int, nodes: torch.Tensor) -> torch.Tensor:
        """Raw scores x . w of level d's nodes (n, K), -1 nodes scoring 0."""
        n, K = nodes.shape
        safe = nodes.clamp(min=0)
        wid = self.ids[d][safe]  # (n, K, P)
        xg = Xd.gather(1, wid.reshape(n, -1)).reshape(wid.shape)
        return torch.where(nodes >= 0, (xg * self.vals[d][safe]).sum(-1), 0.0)

    def beam_search(self, X: smat.csr_matrix, keep_beams: bool = False) -> Dict[str, object]:
        """labels (n, only_topk) int64 (-1 where none), values (n, only_topk)
        float64, margin (n,) the smallest relative margin at a cut, and with
        ``keep_beams`` the nodes entering each level, beams[d] (n, k_d)."""
        X = X.tocsr()
        labels, values, margins = [], [], []
        beams: List[List[torch.Tensor]] = [[] for _ in range(self.depth)]
        for s in range(0, X.shape[0], self.block):
            Xd = self._dense(X[s : s + self.block])
            n = Xd.shape[0]
            parents = torch.zeros((n, 1), dtype=torch.int64, device=self.device)
            pvals = torch.ones((n, 1), dtype=torch.float64, device=self.device)
            margin = torch.full((n,), float("inf"), dtype=torch.float64, device=self.device)
            for d in range(self.depth):
                if keep_beams:
                    beams[d].append(parents.cpu())
                kids = self.children[d]
                cand = kids[parents.clamp(min=0)]  # (n, B, maxc)
                cand = torch.where((parents >= 0)[..., None], cand, -1).reshape(n, -1)
                val = transform(self._scores(Xd, d, cand))
                if d:
                    val = val * pvals.repeat_interleave(kids.shape[1], dim=1)
                val = torch.where(cand >= 0, val, float("-inf"))
                k = min(self.only_topk if d == self.depth - 1 else self.beam_size, cand.shape[1])
                sv, order = torch.sort(val, dim=1, descending=True, stable=True)
                if cand.shape[1] > k:
                    both = torch.isfinite(sv[:, k]) & torch.isfinite(sv[:, k - 1])
                    cut = (sv[:, k - 1] - sv[:, k]) / sv[:, k - 1].abs()
                    margin = torch.minimum(margin, torch.where(both, cut, float("inf")))
                pvals = sv[:, :k]
                parents = torch.where(torch.isfinite(pvals), cand.gather(1, order[:, :k]), -1)
            labels.append(parents.cpu())
            values.append(torch.where(parents >= 0, pvals, 0.0).cpu())
            margins.append(margin.cpu())
        out = {
            "labels": torch.cat(labels).numpy() if labels else np.zeros((0, self.only_topk), np.int64),
            "values": torch.cat(values).numpy() if values else np.zeros((0, self.only_topk)),
            "margin": torch.cat(margins).numpy() if margins else np.zeros(0),
        }
        if keep_beams:
            out["beams"] = [torch.cat(b).numpy() for b in beams]
        return out

    def path_values(self, X: smat.csr_matrix, labels: np.ndarray) -> np.ndarray:
        """(n, k) float64: each label's value along its own path (NaN for -1
        or an id out of range)."""
        X = X.tocsr()
        L = self.ids[-1].shape[0]
        lab = np.where((labels >= 0) & (labels < L), labels, -1).astype(np.int64)
        out = []
        for s in range(0, X.shape[0], self.block):
            Xd = self._dense(X[s : s + self.block])
            node = torch.as_tensor(lab[s : s + self.block], device=self.device)
            val = torch.ones(node.shape, dtype=torch.float64, device=self.device)
            for d in range(self.depth - 1, -1, -1):
                val = val * transform(self._scores(Xd, d, node))
                node = torch.where(node >= 0, self.parent[d][node.clamp(min=0)], -1)
            out.append(val.cpu().numpy())
        vals = np.concatenate(out) if out else np.zeros(lab.shape)
        return np.where(lab >= 0, vals, np.nan)


def build(model, cfg: Dict, device: torch.device) -> Reference:
    """The reference of ``model`` (``xrlinear.Model``): its arrays alone."""
    return Reference(
        model.ids, model.vals, model.parents, model.D, model.bias, int(cfg["beam_size"]),
        int(cfg["only_topk"]), cfg["post_processor"], device,
    )
