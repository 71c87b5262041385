"""HNSW and HNSW-PQ4 models: batched graph build and batched search on one device.

The port of ``pecos_tpu/ann/hnsw/model.py``, with the same parameter classes,
defaults and model folders (``param.json`` + ``graph.npz``, + ``feats.npz``
for CSR features; the PQ4 model adds ``pq.npz``), so a folder saved by either
package loads in the other.

Build (see graph.py): points are inserted in growing batches, each batch
searching the graph as the batches before it left it, selecting its forward
edges with Alg. 4 and merging the reverse edges on the device; a refine pass
then re-searches every node and rebuilds level 0.  With ``build_scan`` (on by
default for dense corpora of 65,536 points or more) the upper-level points go
first, then the level-0 points in fixed batches of ``B`` with same-batch
candidates merged in (``build_intra_k``), and the refine pass searches the
frozen graph (or, with ``refine_fraction`` < 1, re-links the earliest
inserted nodes in place).  The JAX package runs those sweeps as ``lax.scan``
kernels; here they are Python loops with the same order and the same frozen
and carried arrays.  Its all-pad batches, which write nothing, are skipped.

Two options change the build (see ``_GraphBuild``): ``reverse_alg4`` prunes
reverse edges with Alg. 4 on host-grouped destinations (eager mode only), and
``build_pq="true"`` walks level 0 on packed 4-bit PQ codes and rescores the
result exactly.  Sparse features with both raise ``ValueError``: the JAX
package's Alg-4 prune of the packed build takes dense rows only.
"""

from __future__ import annotations

import copy
import dataclasses as dc
import json
import logging
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import scipy.sparse as smat
import torch

import pecos_tpu_torch
from pecos_tpu_torch.utils import smat_util
from pecos_tpu_torch.utils.torch_util import DeviceLike, resolve_device
from .graph import (
    INF,
    PAD,
    DeviceGraph,
    SparseFeats,
    _sort_take,
    batch_greedy_descent_multi,
    batch_search_level,
    batch_search_level_pq,
    batch_search_level_pq_packed,
    batch_select_from_search,
    build_sparse_feats,
    exact_rescore,
    gather_dist,
    pack_neighbor_codes,
    refine_union_candidates,
    reverse_merge_chunk,
    reverse_merge_closest,
    scatter_prune_rows,
    scatter_set_rows,
    scatter_set_rows_d,
    to_device,
)
from .pq import ProductQuantizer4Bits, build_lut, build_lut_device, train_pq4

LOGGER = logging.getLogger(__name__)


def _hash_sketch(X: smat.csr_matrix, sk: int) -> np.ndarray:
    """Count-sketch of CSR rows to sk dense dims: column j adds sign(j) * x_j
    to bucket(j), both taken from a multiplicative hash of j, so <phi(x),
    phi(y)> estimates <x, y> with no (D, sk) projection matrix."""
    h = X.indices.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    bucket = ((h >> np.uint64(40)) % np.uint64(sk)).astype(np.int64)
    sign = np.where((h >> np.uint64(13)) & np.uint64(1), np.float32(1.0), np.float32(-1.0))
    rows = np.repeat(np.arange(X.shape[0], dtype=np.int64), np.diff(X.indptr))
    flat = np.bincount(rows * sk + bucket, weights=X.data * sign, minlength=X.shape[0] * sk)
    return flat.reshape(X.shape[0], sk).astype(np.float32)


def _group_edges(dst: np.ndarray, src: np.ndarray, k_pad: int):
    """src -> dst edges grouped by destination: a list of (rows (A,) int32
    unique destinations, cands (A, k_pad) int32 their sources, -1 padded).
    A node with more than k_pad arrivals gets follow-up groups, applied in
    turn (keep-closest pruning of the chunks in turn equals one pruning of
    their union)."""
    order = np.argsort(dst, kind="stable")
    dst_s, src_s = dst[order], src[order]
    uniq, start, counts = np.unique(dst_s, return_index=True, return_counts=True)
    rank = np.arange(len(dst_s)) - np.repeat(start, counts)
    owner = np.repeat(np.arange(len(uniq)), counts)  # each sorted edge's place in uniq
    out = []
    for chunk in range(-(-int(counts.max(initial=0)) // k_pad)):
        sel = counts > chunk * k_pad
        local = np.cumsum(sel) - 1  # place in uniq -> place in this group's rows
        in_chunk = (rank >= chunk * k_pad) & (rank < (chunk + 1) * k_pad)
        cands = np.full((int(sel.sum()), k_pad), -1, np.int32)
        cands[local[owner[in_chunk]], rank[in_chunk] - chunk * k_pad] = src_s[in_chunk]
        out.append((uniq[sel].astype(np.int32), cands))
    return out


def _padded(idx: np.ndarray, width: int, fill: int) -> np.ndarray:
    """idx (n <= width,) as int64, filled to width with ``fill``."""
    out = np.full(width, fill, np.int64)
    out[: len(idx)] = idx
    return out


def _pad_rows(vals: np.ndarray, n: int, cap: int) -> np.ndarray:
    """vals (b <= n, k) as an (n, cap) int32 block: its first cap columns, -1 padded."""
    out = np.full((n, cap), -1, np.int32)
    k = min(cap, vals.shape[1])
    out[: vals.shape[0], :k] = vals[:, :k]
    return out


def _bucket_pow2(n: int, lo: int, hi: int) -> int:
    return int(min(hi, max(lo, 1 << (max(n, 1) - 1).bit_length())))


class _GraphBuild:
    """One HNSW build on a device: the search copy of the features, the
    level-0 and upper adjacencies, and the insertion and refine sweeps that
    fill them.

    Fast path (keep-closest reverse edges, the default): a distance co-array
    rides beside every adjacency and the reverse edges merge on the device.
    ``reverse_alg4``: no co-arrays; each batch's forward selections come to
    the host, are grouped by destination (``_group_edges``), and every
    destination row is pruned by Alg. 4 over its old and new neighbors
    (``scatter_prune_rows``).

    ``build_pq="true"``: level-0 searches walk 4-bit PQ codes of a guide (the
    search copy of dense features, a count-sketch of sparse ones), scoring a
    popped node's neighbors from one packed row of ``desc`` (N, maxM0 * S),
    on a beam ``build_pq_ef_mult`` wider; the result is rescored exactly
    before selection.  Every write to level 0 re-packs the rows it writes."""

    # device bytes the packed neighbor codes may take (the JAX package's budget)
    BUILD_PQ_HBM_BUDGET = 4608 << 20
    K_PAD = 64  # reverse-edge arrivals per node per prune

    def __init__(self, feats, use_sparse: bool, params, levels: np.ndarray, device: torch.device):
        self.params = params
        self.levels = levels
        self.max_level = int(levels.max())
        self.metric = params.metric_type
        self.N = N = feats.shape[0]
        self.M = params.M
        maxM = params.max_M or params.M
        self.maxM0 = params.max_M0 or 2 * params.M
        self.efC = params.efC
        self.ef_ins = params.build_efC_insert or params.efC
        self.entry = 0
        self.fast = not params.reverse_alg4
        # the PQ guide's subspaces: as many as asked, as the guide's width
        # allows, and as the budget allows the packed codes
        guide_dim = params.build_pq_sketch_dim if use_sparse else feats.shape[1]
        S_req = min(params.build_pq_subspaces, max(1, guide_dim // 2))
        S_pq = max(1, min(S_req, self.BUILD_PQ_HBM_BUDGET // max(1, N * self.maxM0)))
        self.use_pq = params.build_pq == "true" and guide_dim >= 2
        if self.use_pq and use_sparse and not self.fast:
            raise ValueError("reverse_alg4=True with build_pq='true' takes dense features only; the JAX package "
                             "fails on sparse ones (ROADMAP F14): drop one option or pass data_type='drm'")
        if use_sparse:
            self.feats = build_sparse_feats(feats, device=device)
        else:
            self.feats = torch.from_numpy(feats).to(device)
            if params.build_dtype in ("auto", "bfloat16"):
                self.feats = self.feats.to(torch.bfloat16)  # the build's search copy only
        self.expand = params.build_expand or (4 if use_sparse else 8)
        full = lambda shape, v, dt: torch.full(shape, v, dtype=dt, device=device)
        self.n0 = full((N, self.maxM0), -1, torch.int32)
        self.up = [full((N, maxM), -1, torch.int32) for _ in range(self.max_level)]
        self.d0 = full((N, self.maxM0), INF, torch.float32) if self.fast else None
        self.up_d = [full((N, maxM), INF, torch.float32) if self.fast else None for _ in range(self.max_level)]
        # count-sketch of sparse rows: the selection's cross-distances (opt-in) and the sparse PQ guide
        sketch = None
        if use_sparse and (params.build_select_sketch == "true" or self.use_pq):
            sketch = torch.from_numpy(_hash_sketch(feats, guide_dim)).to(device)
        self.sketch = sketch if params.build_select_sketch == "true" else None
        self.guide = self.codes = self.codebooks = self.desc = None
        if self.use_pq:
            t0 = time.time()
            # dense: the codes of the search copy, which the rescore reads; sparse: of the sketch
            self.guide = sketch if use_sparse else self.feats
            pq = train_pq4(sketch.cpu().numpy() if use_sparse else feats, num_subspaces=S_pq, iters=10,
                           seed=params.seed, feats_dev=self.guide, device=device)
            self.codes = torch.from_numpy(pq.codes).to(device)
            self.codebooks = torch.from_numpy(pq.codebooks).to(device)
            self.desc = full((N, self.maxM0 * S_pq), 0, torch.uint8)
            LOGGER.info("hnsw build: PQ guide trained (S=%d) in %.1fs", S_pq, time.time() - t0)
        # one padded batch shape for every level-0 search
        self.B = min(params.build_batch_size, max(32, 1 << (max(N - 1, 1)).bit_length()))
        # rows a reverse-edge prune takes at once: ~2^28 candidate feature elements
        per_row = (self.maxM0 + self.K_PAD) * self.feats.shape[1]
        self.A_CHUNK = int(min(65536, max(4096, (1 << 28) // max(1, per_row))))
        self.device = device

    def _rows(self, idx: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(idx).to(self.device)

    def _packed(self, level: int):
        """The (desc, codes) pair that writes to ``level`` keep in step, or None."""
        return (self.desc, self.codes) if level == 0 and self.use_pq else None

    def search(self, q_idx: np.ndarray, ef: int, at_level: int = 0):
        """Greedy descent through the levels above ``at_level``, then a beam
        search at it, for the nodes q_idx (already padded).  Returns (Q, (ids, dists))."""
        rows = self._rows(q_idx)
        Q = self.feats[rows]
        cur = torch.full((len(q_idx),), self.entry, dtype=torch.long, device=self.device)
        if self.max_level > at_level:
            uppers = [self.up[l - 1] for l in range(self.max_level, at_level, -1)]
            cur = batch_greedy_descent_multi(self.feats, uppers, Q, cur, metric=self.metric, max_steps=64)
        if at_level == 0 and self.use_pq:
            # the guide misranks the beam's tail: walk wider, then rescore exactly
            ef_pq = int(np.ceil(ef * self.params.build_pq_ef_mult))
            Qg = Q if self.guide is self.feats else self.guide[rows]
            lut = build_lut_device(self.codebooks, Qg, metric=self.metric)
            ids, _ = batch_search_level_pq_packed(self.codes, self.n0, self.desc, lut, cur[:, None],
                                                  ef=ef_pq, max_steps=4 * ef_pq, expand=self.expand)
            return Q, exact_rescore(Q, self.feats, ids, metric=self.metric)
        arr = self.n0 if at_level == 0 else self.up[at_level - 1]
        g = DeviceGraph(self.feats, arr, self.metric)
        return Q, batch_search_level(g, Q, cur[:, None], ef=ef, max_steps=4 * ef, expand=self.expand)

    def select(self, ids: torch.Tensor, dists: torch.Tensor):
        return batch_select_from_search(
            self.feats, ids, dists, M=self.M, metric=self.metric, sketch=self.sketch,
            pool=int(self.params.select_pool),
        )

    def link(self, level: int, rows: np.ndarray, sel: torch.Tensor, sel_d: torch.Tensor) -> None:
        """Forward rows set, then their reverse edges merged, at ``level``;
        rows: the batch's nodes, then pads N."""
        arr, arr_d = (self.n0, self.d0) if level == 0 else (self.up[level - 1], self.up_d[level - 1])
        r, packed = self._rows(rows), self._packed(level)
        if self.fast:
            scatter_set_rows_d(arr, arr_d, r, sel, sel_d, packed=packed)
            reverse_merge_closest(arr, arr_d, r, sel, sel_d, packed=packed)
            return
        pts = rows[rows < self.N]
        sel_np = sel[: len(pts)].cpu().numpy()
        scatter_set_rows(arr, r, self._rows(_pad_rows(sel_np, len(rows), arr.shape[1])), packed=packed)
        valid = sel_np >= 0
        if valid.any():
            self.apply_reverse(level, sel_np[valid], np.repeat(pts, valid.sum(axis=1)))

    def apply_reverse(self, level: int, dst: np.ndarray, src: np.ndarray) -> None:
        """The reverse edges dst -> src merged into ``level`` by Alg-4 prunes:
        by destination in groups of K_PAD arrivals, in row chunks of at most
        A_CHUNK.  (The JAX package pads each chunk with rows N to a power of
        two, at least 1,024, to reuse compiled shapes; those rows write
        nothing, and here they would only cost work.)"""
        arr, packed = (self.n0 if level == 0 else self.up[level - 1]), self._packed(level)
        for rows, cands in _group_edges(dst, src, self.K_PAD):
            for a0 in range(0, len(rows), self.A_CHUNK):
                scatter_prune_rows(
                    arr, self.feats, self._rows(rows[a0 : a0 + self.A_CHUNK]),
                    self._rows(cands[a0 : a0 + self.A_CHUNK]), metric=self.metric, alg4=True, packed=packed,
                )

    def insert_growing(self, order: np.ndarray) -> None:
        """Batches of 32, then as large as everything inserted so far, up to
        B; each point is linked at every level it lives on, with a search at
        that level."""
        B, N, levels = self.B, self.N, self.levels
        pos, bs = 0, 32
        while pos < len(order):
            batch = order[pos : pos + bs]
            _, (ids, d) = self.search(_padded(batch, B, 0), self.ef_ins)
            self.link(0, _padded(batch, B, N), *self.select(ids, d))
            for l in range(1, self.max_level + 1):
                pts = batch[levels[batch] >= l]
                if len(pts):
                    B_up = _bucket_pow2(len(pts), 32, B)  # upper levels hold ~1/M of a batch
                    _, (ids_l, d_l) = self.search(_padded(pts, B_up, 0), self.efC, at_level=l)
                    self.link(l, _padded(pts, B_up, N), *self.select(ids_l, d_l))
            top = batch[np.argmax(levels[batch])]
            if levels[top] > levels[self.entry]:
                self.entry = int(top)
            pos += len(batch)
            bs = min(B, max(32, pos + 1))
            if pos % (64 * B) < len(batch):
                LOGGER.info("hnsw build: %d/%d inserted", pos + 1, N)

    def _intra_merge(self, Q, rows: torch.Tensor, ids, dists, k: int):
        """The k closest same-batch points merged into each candidate list
        (they are not in the searched graph yet), width kept."""
        Qf = Q.float()
        dots = Qf @ Qf.T
        if self.metric == "ip":
            Dq = 1.0 - dots
        else:
            nn = (Qf * Qf).sum(-1)
            Dq = nn[:, None] + nn[None, :] - 2.0 * dots
        mask = ((rows >= self.N) | (rows < 0))[None, :] | torch.eye(len(rows), dtype=torch.bool, device=rows.device)
        top_d, idx = torch.sort(torch.where(mask, INF, Dq), dim=1, stable=True)
        top_d, idx = top_d[:, :k], idx[:, :k]
        real = top_d < INF / 2
        all_ids = torch.cat([ids, torch.where(real, rows[idx], -1)], dim=1)
        all_d = torch.cat([dists, torch.where(real, top_d, INF)], dim=1)
        all_d, order = torch.sort(all_d, dim=1, stable=True)
        E = ids.shape[1]
        return all_ids.gather(1, order)[:, :E], all_d[:, :E]

    def insert_fixed(self, pts: np.ndarray) -> None:
        """The scan mode's level-0 sweep: batches of B (pads N, searched as
        node N-1) over the finished upper levels, same-batch candidates merged."""
        B, N = self.B, self.N
        intra_k = min(int(self.params.build_intra_k), B - 1) if isinstance(self.feats, torch.Tensor) else 0
        t0 = time.time()
        for s in range(0, len(pts), B):
            rows = _padded(pts[s : s + B], B, N)
            Q, (ids, d) = self.search(np.minimum(rows, N - 1), self.ef_ins)
            if intra_k > 0:
                ids, d = self._intra_merge(Q, self._rows(rows), ids, d, intra_k)
            self.link(0, rows, *self.select(ids, d))
        LOGGER.info("hnsw build: level-0 sweep of %d points (%.1fs)", len(pts), time.time() - t0)

    def _union_gathered(self, nodes: torch.Tensor, ids: torch.Tensor, dists: torch.Tensor):
        """refine_union_candidates without a co-array (the Alg-4 build): the
        current neighbors' distances gathered from the features."""
        nodes, ids = nodes.long(), ids.long()
        self_mask = ids == nodes[:, None]
        ids, dists = torch.where(self_mask, PAD, ids), torch.where(self_mask, INF, dists)
        safe = nodes.clamp(0, self.N - 1)
        ex = self.n0[safe].long()
        ex_d = torch.where(ex >= 0, gather_dist(self.feats[safe], self.feats, ex, self.metric), INF)
        dup = (ex[:, :, None] == ids[:, None, :]).any(dim=2)
        ex_d = torch.where(dup | (nodes[:, None] < 0), INF, ex_d)
        ex = torch.where(dup, PAD, ex)
        all_d, all_ids = _sort_take(torch.cat([dists, ex_d], dim=1), torch.cat([ids, ex], dim=1))
        return all_ids, all_d

    def _reselect(self, q_idx: np.ndarray, keys: np.ndarray):
        """A node's refine: its search at efC, united with its current
        neighbors, selected again.  keys: the nodes, -2 at the pads."""
        _, (ids, d) = self.search(q_idx, self.efC)
        if self.fast:
            all_ids, all_d = refine_union_candidates(self.n0, self.d0, self._rows(keys), ids, d)
        else:
            all_ids, all_d = self._union_gathered(self._rows(keys), ids, d)
        return self.select(all_ids, all_d)

    def refine_full(self, scan: bool) -> None:
        """Every node re-searched on the frozen graph; level 0 rebuilt from
        the new forward lists (its packed codes re-packed), then their reverse
        edges merged: chunk by chunk on the device, or by Alg-4 prunes."""
        B, N, M = self.B, self.N, self.M
        N_CEIL = -(-N // B) * B
        new_ids = torch.full((N_CEIL, M), -1, dtype=torch.int32, device=self.device)
        new_d = torch.full((N_CEIL, M), INF, device=self.device)
        for s0 in range(0, N, B):
            nodes = np.arange(s0, min(s0 + B, N))
            q_idx = _padded(nodes, B, N - 1 if scan else 0)
            sel, sel_d = self._reselect(q_idx, _padded(nodes, B, -2))
            scatter_set_rows_d(new_ids, new_d, self._rows(_padded(nodes, B, N_CEIL)), sel, sel_d)
        pad = lambda x, v: torch.cat([x[:N], torch.full((N, self.maxM0 - M), v, dtype=x.dtype, device=x.device)], dim=1)
        self.n0 = pad(new_ids, -1)
        if self.use_pq:
            self.desc = None  # the stale codes go first
            self.desc = pack_neighbor_codes(self.n0, self.codes)
        if self.fast:
            self.d0 = pad(new_d, INF)
            for s0 in range(0, N_CEIL, B):
                reverse_merge_chunk(self.n0, self.d0, new_ids, new_d, s0, B=B, packed=self._packed(0))
            return
        fwd = new_ids[:N].cpu().numpy()
        valid = fwd >= 0
        self.apply_reverse(0, fwd[valid], np.repeat(np.arange(N), valid.sum(axis=1)))

    def refine_partial(self, nodes: np.ndarray) -> None:
        """The given nodes re-searched and re-linked in place, batch by batch, on the live graph."""
        B, N = self.B, self.N
        for s in range(0, len(nodes), B):
            rows = _padded(nodes[s : s + B], B, N)
            sel, sel_d = self._reselect(np.minimum(rows, N - 1), np.where(rows >= N, -2, rows))
            self.link(0, rows, sel, sel_d)


class HNSW(pecos_tpu_torch.BaseClass):
    @dc.dataclass
    class TrainParams(pecos_tpu_torch.BaseParams):
        """The JAX package's fields and defaults (its docstrings say what each
        does).  ``reverse_alg4=True`` with ``build_pq="true"`` on sparse
        features raises ValueError (the JAX package fails there);
        ``build_pq_min_points`` is read by nothing, as in the JAX package;
        ``threads`` is kept for parity."""

        M: int = 32
        efC: int = 100
        max_level_upper_bound: int = 5
        metric_type: str = "ip"  # ip | l2
        max_M: Optional[int] = None  # upper-level degree cap, default M
        max_M0: Optional[int] = None  # level-0 degree cap, default 2*M
        seed: int = 0
        threads: int = -1
        build_batch_size: int = 2048
        refine_iters: int = 1
        build_efC_insert: int = 0  # level-0 insertion beam; 0 = efC
        reverse_alg4: bool = False  # Alg-4 (vs keep-closest) reverse-edge prune, eager mode only
        build_expand: int = 0  # pops per search step in the build; 0 = 8 dense, 4 sparse
        build_dtype: str = "auto"  # auto (bfloat16 dense, float32 sparse) | float32 | bfloat16
        data_type: str = "auto"  # auto | drm | csr
        sparse_dim_threshold: int = 65536
        build_pq: str = "auto"  # auto (off) | true | false: the PQ-guided level-0 walk
        build_pq_subspaces: int = 64
        build_pq_min_points: int = 50000
        build_pq_sketch_dim: int = 128  # the sparse guide's count-sketch width
        build_select_sketch: str = "false"  # true | false
        select_pool: int = 0
        build_pq_ef_mult: float = 1.3  # the PQ-guided walk's beam, a multiple of ef
        build_scan: str = "auto"  # auto (dense, N >= 65536, fast path) | true | false
        build_intra_k: int = 32
        refine_fraction: float = 1.0

    @dc.dataclass
    class PredParams(pecos_tpu_torch.BaseParams):
        efS: int = 100
        topk: int = 10
        threads: int = -1  # parity only
        batch_size: int = 2048  # queries per lockstep search

    def __init__(
        self,
        feats,
        neighbors0: np.ndarray,
        upper_neighbors: np.ndarray,
        node_levels: np.ndarray,
        entry_point: int,
        metric: str,
        pred_params=None,
        device: DeviceLike = "cuda",
    ):
        """A graph from host arrays: those of ``train``, of a saved folder, or
        of an index the JAX package built (its model's attributes of the same names)."""
        self.feats = feats  # (N, D) float32 ndarray, or CSR
        self.neighbors0 = neighbors0  # (N, maxM0) int32
        self.upper_neighbors = upper_neighbors  # (max_level, N, maxM) int32
        self.node_levels = node_levels  # (N,) int32
        self.entry_point = int(entry_point)
        self.metric = metric
        self.pred_params = self.PredParams.from_dict(pred_params)
        self.device = resolve_device(device)
        self._dev: Dict[torch.device, Tuple[DeviceGraph, list]] = {}

    def to(self, device: DeviceLike) -> "HNSW":
        """Serve from ``device``; each device's copy is uploaded once and kept."""
        self.device = resolve_device(device)
        return self

    def _device(self) -> Tuple[DeviceGraph, list]:
        """(level-0 graph, upper-level graphs) on the model's device."""
        if self.device not in self._dev:
            g0 = DeviceGraph.from_numpy(self.feats, self.neighbors0, self.metric, self.device)
            uppers = [DeviceGraph(g0.feats, to_device(u, np.int32, self.device), self.metric) for u in self.upper_neighbors]
            self._dev[self.device] = (g0, uppers)
        return self._dev[self.device]

    @classmethod
    def train(cls, X, train_params=None, pred_params=None, device: DeviceLike = "cuda", **kwargs) -> "HNSW":
        """Build the graph on ``device``: batched insertion, then
        ``refine_iters`` refine passes (see the module docstring)."""
        params = cls.TrainParams.from_dict(train_params)
        params.override_with_kwargs(kwargs)
        dev = resolve_device(device)
        use_sparse = smat.issparse(X) and (
            params.data_type == "csr"
            or (params.data_type == "auto" and X.shape[1] > params.sparse_dim_threshold)
        )
        if use_sparse:
            feats = X.tocsr().astype(np.float32)
        elif smat.issparse(X):
            feats = np.asarray(X.todense(), np.float32)
        else:
            feats = np.asarray(X, np.float32)
        N = feats.shape[0]
        M = params.M
        # geometric levels from numpy: the same draws as the JAX package
        rng = np.random.default_rng(params.seed)
        mult = 1.0 / np.log(max(M, 2))
        levels = np.minimum(
            (-np.log(rng.uniform(size=N, low=1e-12)) * mult).astype(np.int32),
            params.max_level_upper_bound,
        )
        levels[0] = levels.max()  # the first point anchors the top level

        build = _GraphBuild(feats, use_sparse, params, levels, dev)
        use_scan = params.build_scan == "true" or (
            params.build_scan == "auto" and build.fast and N >= 65536 and not use_sparse
        )
        if use_scan and not build.fast:
            LOGGER.warning("build_scan requires the device-resident (fast) path; ignoring")
            use_scan = False
        l0_pts = np.zeros(0, np.int64)
        if use_scan:
            upper_pts, l0_pts = np.where(levels >= 1)[0], np.where(levels == 0)[0]
            build.insert_growing(upper_pts[upper_pts != 0])
            l0_pts = l0_pts[l0_pts != 0]
            build.insert_fixed(l0_pts)
        else:
            build.insert_growing(np.arange(1, N))
        for it in range(max(0, params.refine_iters)):
            LOGGER.info("hnsw refine pass %d/%d", it + 1, params.refine_iters)
            if use_scan and 0.0 < params.refine_fraction < 1.0:
                # the earliest-inserted fraction of level 0, and every upper-level point
                n_part = int(params.refine_fraction * len(l0_pts))
                build.refine_partial(np.concatenate([np.where(levels > 0)[0], l0_pts[:n_part]]))
            else:
                build.refine_full(scan=use_scan)
        max_level = build.max_level
        uppers = (
            np.stack([u.cpu().numpy() for u in build.up])
            if max_level
            else np.zeros((0, N, params.max_M or M), np.int32)
        )
        return cls(feats, build.n0.cpu().numpy(), uppers, levels, build.entry, params.metric_type, pred_params, device=dev)

    def _descend(self, Qd, uppers, nrows: int) -> torch.Tensor:
        cur = torch.full((nrows,), self.entry_point, dtype=torch.long, device=self.device)
        if uppers:
            top_first = [uppers[l - 1].neighbors for l in range(len(uppers), 0, -1)]
            cur = batch_greedy_descent_multi(uppers[0].feats, top_first, Qd, cur, metric=self.metric, max_steps=64)
        return cur

    def predict(self, X, pred_params=None, ret_csr: bool = False, **kwargs):
        """(ids (n, topk) int32, dists float32) ascending by distance, or with
        ``ret_csr`` a CSR of scores -dist.  Queries go in lockstep chunks of
        ``batch_size``; when there is more than one chunk each is padded to
        the full size with zero rows (batch composition changes results, so
        the padding is the JAX package's)."""
        params = self.get_pred_params() if pred_params is None else self.PredParams.from_dict(pred_params)
        params.override_with_kwargs(kwargs)
        efS, topk = params.efS, params.topk
        ef = max(efS, topk)
        g0, uppers = self._device()
        sparse_graph = isinstance(g0.feats, SparseFeats)
        if sparse_graph:
            Q = X.tocsr().astype(np.float32) if smat.issparse(X) else smat.csr_matrix(np.asarray(X, np.float32))
            qcap = 32 * -(-int(max(np.diff(Q.indptr).max(initial=0), 1)) // 32)  # one width for every chunk
        else:
            Q = np.asarray(X.todense(), np.float32) if smat.issparse(X) else np.asarray(X, np.float32)
        NQ = Q.shape[0]
        chunk = max(1, params.batch_size)
        ids = np.empty((NQ, topk), np.int32)
        dists = np.empty((NQ, topk), np.float32)
        for s in range(0, NQ, chunk):
            Qc = Q[s : s + chunk]
            pad = chunk - Qc.shape[0] if NQ > chunk else 0
            if sparse_graph:
                if pad:
                    Qc = smat.vstack([Qc, smat.csr_matrix((pad, Q.shape[1]), dtype=np.float32)]).tocsr()
                sf = build_sparse_feats(Qc, cap=qcap, device=self.device)
                Qd = sf[:]
            else:
                if pad:
                    Qc = np.vstack([Qc, np.zeros((pad, Q.shape[1]), np.float32)])
                Qd = to_device(Qc, np.float32, self.device)
            cur = self._descend(Qd, uppers, Qc.shape[0])
            ids_c, dists_c = batch_search_level(g0, Qd, cur[:, None], ef=ef, max_steps=4 * ef)
            n = min(chunk, NQ - s)
            ids[s : s + n] = ids_c[:n, :topk].cpu().numpy()
            dists[s : s + n] = dists_c[:n, :topk].cpu().numpy()
        if ret_csr:
            return smat_util.csr_from_topk_arrays(ids.astype(np.int64), -dists.astype(np.float32), self.feats.shape[0])
        return ids, dists

    def get_pred_params(self):
        return copy.deepcopy(self.pred_params)

    def save(self, folder: str):
        os.makedirs(folder, exist_ok=True)
        param = self.append_meta(
            {
                "model": type(self).__name__,
                "metric": self.metric,
                "entry_point": self.entry_point,
                "pred_kwargs": self.pred_params.to_dict(),
            }
        )
        sparse = bool(smat.issparse(self.feats))
        param["sparse_feats"] = sparse
        with open(os.path.join(folder, "param.json"), "w") as f:
            json.dump(param, f, indent=True)
        arrays = dict(neighbors0=self.neighbors0, upper_neighbors=self.upper_neighbors, node_levels=self.node_levels)
        if sparse:
            smat_util.save_matrix(os.path.join(folder, "feats.npz"), self.feats)
        else:
            arrays = dict(feats=self.feats, **arrays)
        np.savez(os.path.join(folder, "graph.npz"), **arrays)

    @classmethod
    def load(cls, folder: str, device: DeviceLike = "cuda") -> "HNSW":
        with open(os.path.join(folder, "param.json")) as f:
            param = json.load(f)
        with np.load(os.path.join(folder, "graph.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        if param.get("sparse_feats"):
            feats = smat_util.load_matrix(os.path.join(folder, "feats.npz")).tocsr()
        else:
            feats = arrays["feats"]
        pred = {k: v for k, v in param.get("pred_kwargs", {}).items() if k in ("efS", "topk", "threads")}
        return cls(
            feats, arrays["neighbors0"], arrays["upper_neighbors"], arrays["node_levels"],
            param["entry_point"], param["metric"], pred_params=pred, device=device,
        )


class HNSWProductQuantizer4Bits(pecos_tpu_torch.BaseClass):
    """HNSW searched on 4-bit PQ codes of its level-0 features, the top
    ``num_rerank`` re-ranked by exact distance.  Dense features only."""

    @dc.dataclass
    class TrainParams(pecos_tpu_torch.BaseParams):
        hnsw_params: Optional["HNSW.TrainParams"] = None
        num_subspaces: int = 64
        kmeans_iters: int = 10
        seed: int = 0

    @dc.dataclass
    class PredParams(pecos_tpu_torch.BaseParams):
        efS: int = 100
        topk: int = 10
        num_rerank: int = 100
        threads: int = -1
        batch_size: int = 2048
        # neighbor codes packed beside each adjacency row (pack_neighbor_codes):
        # "auto" packs when the (N, M*S) uint8 array fits PACKED_HBM_BUDGET
        packed: str = "auto"  # auto | true | false

    PACKED_HBM_BUDGET = 6 << 30

    def __init__(self, hnsw: HNSW, pq: ProductQuantizer4Bits, pred_params=None):
        self.hnsw = hnsw
        self.pq = pq
        self.pred_params = self.PredParams.from_dict(pred_params)
        self._codes: Dict[torch.device, torch.Tensor] = {}
        self._nbr_codes: Dict[torch.device, torch.Tensor] = {}

    @property
    def device(self) -> torch.device:
        return self.hnsw.device

    def to(self, device: DeviceLike) -> "HNSWProductQuantizer4Bits":
        self.hnsw.to(device)
        return self

    @classmethod
    def train(cls, X, train_params=None, pred_params=None, device: DeviceLike = "cuda", **kwargs) -> "HNSWProductQuantizer4Bits":
        params = cls.TrainParams.from_dict(train_params)
        params.override_with_kwargs(kwargs)
        hp = HNSW.TrainParams.from_dict(params.hnsw_params)
        hp.data_type = "drm"  # codes quantize dense rows
        hnsw = HNSW.train(X, train_params=hp, device=device)
        return cls.from_hnsw(hnsw, num_subspaces=params.num_subspaces, kmeans_iters=params.kmeans_iters,
                             seed=params.seed, pred_params=pred_params)

    @classmethod
    def from_hnsw(cls, hnsw: HNSW, *, num_subspaces: int = 64, kmeans_iters: int = 10, seed: int = 0,
                  pred_params=None) -> "HNSWProductQuantizer4Bits":
        """Codebooks and codes trained on the features of a graph already
        built, on the graph's device; the graph itself is reused."""
        if smat.issparse(hnsw.feats):
            raise ValueError("PQ4 quantization requires dense features (data_type='drm')")
        pq = train_pq4(hnsw.feats, num_subspaces=num_subspaces, iters=kmeans_iters, seed=seed, device=hnsw.device)
        return cls(hnsw, pq, pred_params=pred_params)

    def predict(self, X, pred_params=None, **kwargs):
        """(ids (n, topk) int32, exact dists float32), ascending."""
        params = self.get_pred_params() if pred_params is None else self.PredParams.from_dict(pred_params)
        params.override_with_kwargs(kwargs)
        Q = np.asarray(X.todense(), np.float32) if smat.issparse(X) else np.asarray(X, np.float32)
        NQ = Q.shape[0]
        dev = self.device
        g0, uppers = self.hnsw._device()
        if dev not in self._codes:
            self._codes[dev] = to_device(self.pq.codes, np.uint8, dev)
        codes = self._codes[dev]
        N, M = g0.neighbors.shape
        use_packed = params.packed == "true" or (
            params.packed == "auto" and N * M * self.pq.codes.shape[1] <= self.PACKED_HBM_BUDGET
        )
        if use_packed and dev not in self._nbr_codes:
            self._nbr_codes[dev] = pack_neighbor_codes(g0.neighbors, codes)
        metric, topk, chunk = self.hnsw.metric, params.topk, max(1, params.batch_size)
        ef = max(params.efS, params.num_rerank, topk)
        out_ids = np.empty((NQ, topk), np.int32)
        out_d = np.empty((NQ, topk), np.float32)
        for s in range(0, NQ, chunk):
            Qc = Q[s : s + chunk]
            pad = chunk - Qc.shape[0] if NQ > chunk else 0
            if pad:
                Qc = np.vstack([Qc, np.zeros((pad, Q.shape[1]), np.float32)])
            Qd = to_device(Qc, np.float32, dev)
            cur = self.hnsw._descend(Qd, uppers, Qc.shape[0])[:, None]
            lut = torch.from_numpy(build_lut(self.pq, Qc, metric)).to(dev)
            if use_packed:
                ids, _ = batch_search_level_pq_packed(codes, g0.neighbors, self._nbr_codes[dev], lut, cur,
                                                      ef=ef, max_steps=4 * ef)
            else:
                ids, _ = batch_search_level_pq(codes, g0.neighbors, lut, cur, ef=ef, max_steps=4 * ef)
            # exact rerank of the top num_rerank
            top = ids[:, : params.num_rerank]
            exact = torch.where(top >= 0, gather_dist(Qd, g0.feats, top, metric), INF)
            k = min(topk, exact.shape[1])
            best_d, pos = torch.sort(exact, dim=1, stable=True)
            n = min(chunk, NQ - s)
            out_ids[s : s + n] = top.gather(1, pos[:, :k])[:n].cpu().numpy()
            out_d[s : s + n] = best_d[:n, :k].cpu().numpy()
        return out_ids, out_d

    def get_pred_params(self):
        return copy.deepcopy(self.pred_params)

    def save(self, folder: str):
        os.makedirs(folder, exist_ok=True)
        self.hnsw.save(os.path.join(folder, "hnsw"))
        np.savez(os.path.join(folder, "pq.npz"), codebooks=self.pq.codebooks, codes=self.pq.codes, dim=np.int64(self.pq.dim))
        with open(os.path.join(folder, "param.json"), "w") as f:
            json.dump(self.append_meta({"pred_kwargs": self.pred_params.to_dict()}), f)

    @classmethod
    def load(cls, folder: str, device: DeviceLike = "cuda") -> "HNSWProductQuantizer4Bits":
        hnsw = HNSW.load(os.path.join(folder, "hnsw"), device=device)
        with np.load(os.path.join(folder, "pq.npz")) as z:
            pq = ProductQuantizer4Bits(codebooks=z["codebooks"], codes=z["codes"], dim=int(z["dim"]))
        with open(os.path.join(folder, "param.json")) as f:
            param = json.load(f)
        keep = ("efS", "topk", "num_rerank", "threads", "packed")
        return cls(hnsw, pq, pred_params={k: v for k, v in param.get("pred_kwargs", {}).items() if k in keep})
