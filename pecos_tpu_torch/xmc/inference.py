"""Beam-search inference engine for hierarchical linear models, in PyTorch.

The port of ``pecos_tpu/xmc/inference.py``: the same static-shape beam search
over padded children tables, run eagerly on one torch device.

- A layer lives on the device in one of two layouts (:class:`DeviceLayer`):
  ``dense`` — W as a dense (D+1, L) matrix, for the small upper levels; or
  ``plabel`` — every label's pruned sparse weight vector padded to P slots and
  packed as [ids | float bits], one row per label, read by candidate id.
- One beam step expands the beam's parents into candidates, scores them,
  applies the post-processor's transform and combiner, masks invalid
  candidates and keeps the top k.
- plabel layers score sparse queries with K1 (``pecos_tpu_torch.ops.intersect``),
  the CUDA kernel on a GPU and its plain version on the CPU; dense queries
  (``single_layer_predict``, ``score_selected_labels``, the streaming
  ``MmapCompiledHierModel``) are scored by a gather of x at the weight ids.
- Sparse queries reach the device padded.  On the float32 wire a batch
  travels as its CSR slice (``csr_rows``) and is padded on the device
  (``pad_csr_on_device``); the packed wires carry the host-padded block in one
  uint16 buffer (``encode_wire_batch`` on the host, ``decode_wire_batch`` on
  the device), whose layout and rounding are the JAX package's bit for bit.
- ``RealtimeSession`` serves small batches with one upload, one beam walk and
  one fetch per call; ``save_compiled_layers``/``load_compiled_layers`` keep
  the device layouts on disk in the JAX package's format.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as smat
import torch

from pecos_tpu_torch.ops.intersect import intersect_scores_rows, split_packed, take_pass_counts
from pecos_tpu_torch.utils import smat_util
from pecos_tpu_torch.utils.cluster_util import padded_children
from pecos_tpu_torch.utils.profile_util import count, span
from pecos_tpu_torch.utils.torch_util import DeviceLike, resolve_device
from .postprocessor import PostProcessor

NEG_INF = -1e30
# layers whose dense W would exceed this many elements use the plabel layout
DENSE_LAYOUT_MAX_ELEMENTS = 1 << 24
# dense-query scoring of a plabel layer gathers (rows, K, P) weight blocks:
# rows are taken in chunks of at most this many elements, which bounds the
# intermediates (~24 bytes an element) whatever the batch
_GATHER_BLOCK_ELEMENTS = 1 << 20
WIRE_VALUE_DTYPES = ("float32", "float16", "bfloat16", "uint8")


@dataclasses.dataclass
class DeviceLayer:
    """One model layer resident on a torch device."""

    kind: str  # "dense" | "plabel"
    nr_labels: int
    children: torch.Tensor  # (n_parents, max_children) int64, -1 padded
    W: Optional[torch.Tensor] = None  # dense: (D+1, L) float32
    packed: Optional[torch.Tensor] = None  # plabel: (L, 2P) int32 [ids | float bits]

    @property
    def max_children(self) -> int:
        return self.children.shape[1]

    @property
    def device(self) -> torch.device:
        return self.children.device

    @property
    def nbytes(self) -> int:
        """Bytes of the layer's tensors on its device."""
        tensors = (self.children, self.W, self.packed)
        return sum(t.numel() * t.element_size() for t in tensors if t is not None)

    def to(self, device: DeviceLike) -> "DeviceLayer":
        dev = resolve_device(device)
        move = lambda t: None if t is None else t.to(dev)
        return DeviceLayer(self.kind, self.nr_labels, move(self.children), move(self.W), move(self.packed))


def _plabel_packed(W: smat.csc_matrix) -> np.ndarray:
    """(L, 2P) int32 [ids | float bits] with P the max column nnz rounded up to 8."""
    L = W.shape[1]
    nnz = np.diff(W.indptr)
    cap = max(8, -(-int(nnz.max() if L else 0) // 8) * 8)
    ids = np.zeros((L, cap), dtype=np.int32)
    vals = np.zeros((L, cap), dtype=np.float32)
    rows = np.repeat(np.arange(L), nnz)
    offs = np.arange(W.nnz) - np.repeat(W.indptr[:-1], nnz)
    ids[rows, offs] = W.indices
    vals[rows, offs] = W.data
    return np.concatenate([ids, vals.view(np.int32)], axis=1)


def build_device_layer(
    W: smat.spmatrix,
    C: smat.spmatrix,
    *,
    layout: Optional[str] = None,
    device: DeviceLike = "cuda",
) -> DeviceLayer:
    """Device layout for one layer from host CSC W (D+1, L) and C (L, n_parents),
    in span ``pecos.layouts``."""
    with span("pecos.layouts"):
        W = W.tocsc()
        n_feat_b, L = W.shape
        children, _ = padded_children(C)
        if layout is None:
            layout = "dense" if n_feat_b * L <= DENSE_LAYOUT_MAX_ELEMENTS else "plabel"
        if layout == "dense":
            arrays = {"W": np.asarray(W.todense(), dtype=np.float32)}
        elif layout == "plabel":
            arrays = {"packed": _plabel_packed(W)}
        else:
            raise ValueError(f"unknown layout {layout!r}")
        return layers_from_numpy(
            [{"kind": layout, "nr_labels": L, "children": children, **arrays}], device
        )[0]


def layers_from_numpy(layers: Sequence[Dict], device: DeviceLike) -> List[DeviceLayer]:
    """DeviceLayers from numpy arrays named like the DeviceLayer fields (kind,
    nr_labels, children, W | packed); the JAX package's layers, passed through
    ``np.asarray``, carry over as they are.  Their ``parent_packed`` key, the
    JAX package's copy of the packed rows grouped by parent, is ignored."""
    dev = resolve_device(device)
    # copies: the tensors own their memory even where the arrays are read-only views
    tensor = lambda a, dtype: torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(dev)
    out = []
    for d in layers:
        children = tensor(d["children"], np.int64)
        if d["kind"] == "dense":
            out.append(DeviceLayer("dense", int(d["nr_labels"]), children, W=tensor(d["W"], np.float32)))
        elif d["kind"] == "plabel":
            out.append(DeviceLayer("plabel", int(d["nr_labels"]), children, packed=tensor(d["packed"], np.int32)))
        else:
            raise ValueError(f"unknown layer kind {d['kind']!r}")
    return out


def prepare_queries(X, bias: float) -> np.ndarray:
    """Dense (N, D+1) query block with the bias column appended."""
    Xd = np.asarray(X.todense() if smat.issparse(X) else X, dtype=np.float32)
    if bias > 0:
        Xd = np.hstack([Xd, np.full((Xd.shape[0], 1), bias, dtype=np.float32)])
    return Xd


def query_cap(A: smat.csr_matrix) -> int:
    """The padded width of CSR queries ``A``: the longest row's nonzeros
    rounded up to a power of two, at least 64."""
    max_nnz = int(np.diff(A.indptr).max()) if A.shape[0] else 1
    return max(64, 1 << max(0, max_nnz - 1).bit_length())


def prepare_queries_padded(X: smat.spmatrix, cap: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Sparse queries as padded (ids int32, vals float32), each (N, cap).

    Id D+1 with value 0 marks padding.  ``cap`` defaults to ``query_cap``.
    """
    A = X.tocsr()
    nnz = np.diff(A.indptr)
    if cap is None:
        cap = query_cap(A)
    D = A.shape[1]
    if A.shape[0] and A.nnz == A.shape[0] * cap and int(nnz.max()) == cap:
        # every row full: the padded layout is a reshape of the CSR arrays
        return (
            np.ascontiguousarray(A.indices.reshape(A.shape[0], cap), np.int32),
            np.ascontiguousarray(A.data.reshape(A.shape[0], cap), np.float32),
        )
    ids = np.full((A.shape[0], cap), D + 1, dtype=np.int32)
    vals = np.zeros((A.shape[0], cap), dtype=np.float32)
    rows = np.repeat(np.arange(A.shape[0]), nnz)
    offs = np.arange(A.nnz) - np.repeat(A.indptr[:-1], nnz)
    ids[rows, offs] = A.indices
    vals[rows, offs] = A.data
    return ids, vals


def pad_query_rows(ids: np.ndarray, vals: np.ndarray, n_rows: int, D: int) -> Tuple[np.ndarray, np.ndarray]:
    """Padded queries grown to ``n_rows`` with empty rows (ids D+1, values 0)."""
    pad = n_rows - ids.shape[0]
    if pad <= 0:
        return ids, vals
    return (
        np.vstack([ids, np.full((pad, ids.shape[1]), D + 1, np.int32)]),
        np.vstack([vals, np.zeros((pad, vals.shape[1]), np.float32)]),
    )


def csr_rows(A: smat.csr_matrix, s: int, e: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rows [s, e) of CSR ``A`` read from its own arrays, no scipy slice:
    (indptr int64 from 0, indices int32, data float32), views where A's
    dtypes already match.  The casts round as ``prepare_queries_padded``'s
    assignment does."""
    a, b = int(A.indptr[s]), int(A.indptr[e])
    return (
        np.subtract(A.indptr[s : e + 1], a, dtype=np.int64),
        np.asarray(A.indices[a:b], np.int32),
        np.asarray(A.data[a:b], np.float32),
    )


def pad_csr_on_device(
    indptr: torch.Tensor, indices: torch.Tensor, data: torch.Tensor, n_rows: int, cap: int, D: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Padded queries built on the tensors' device from a CSR slice
    (``csr_rows``'s arrays): m <= ``n_rows`` rows of at most ``cap`` nonzeros
    -> (ids int32, vals float32), each (n_rows, cap), equal bit for bit to
    ``pad_query_rows(*prepare_queries_padded(rows, cap=cap), n_rows, D)``.

    Nonzero j of row r lands in slot j - indptr[r] of row r, in the CSR's
    order (unsorted ids, duplicates and explicit zeros as they are); the
    other slots, and the rows past m, hold id D+1 and value 0.  The nonzero
    count is the host-known length of ``indices``, so nothing waits on the
    device."""
    m, nnz, dev = indptr.shape[0] - 1, indices.shape[0], indices.device
    ids = torch.full((n_rows * cap,), D + 1, dtype=torch.int32, device=dev)
    vals = torch.zeros(n_rows * cap, dtype=torch.float32, device=dev)
    # flat slot of nonzero j of row r: j + (r * cap - indptr[r])
    shift = torch.arange(0, m * cap, cap, device=dev) - indptr[:-1]
    slot = torch.arange(nnz, device=dev) + shift.repeat_interleave(indptr.diff(), output_size=nnz)
    ids.scatter_(0, slot, indices)
    vals.scatter_(0, slot, data)
    return ids.view(n_rows, cap), vals.view(n_rows, cap)


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``; to a GPU from pinned memory without blocking."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def scatter_queries(ids: torch.Tensor, vals: torch.Tensor, D: int, bias: float) -> torch.Tensor:
    """Densify padded queries on the device: (B, cap) -> (B, D+1) with bias.

    One scatter-add into a (B, D+2) buffer: column D holds the bias feature,
    column D+1 takes the padding and is cut off.  Ids lie in [0, D-1] or are
    D+1 by construction (``prepare_queries_padded``), so none is out of range.
    """
    X = torch.zeros((ids.shape[0], D + 2), dtype=torch.float32, device=ids.device)
    X.scatter_add_(1, ids.long(), vals)
    if bias > 0:
        X[:, D] = bias
    return X[:, : D + 1]


# ---------------------------------------------------------------------------
# the query wire: one uint16 buffer per batch
# ---------------------------------------------------------------------------
#
# Row layout (that of the JAX package): [lo ids: cap words | hi words: nw low
# halves, then nw high halves | values].  An id's low 16 bits travel in ``lo``;
# its remaining hi_bits = bit_length(D+1) - 16 bits are packed 32 // hi_bits to
# a uint32 word.  Values: float32 as two planes (low halves, then high
# halves), float16/bfloat16 as one word each, uint8 as signed 8-bit multiples
# of a per-row float16 step, two to a word, followed by the step's bits.


def check_wire_value_dtype(val_dtype: str, cap: Optional[int] = None) -> None:
    """Raise ValueError for a wire dtype the codec does not know, or for the
    uint8 wire with an odd ``cap`` (its bytes travel in pairs)."""
    if val_dtype not in WIRE_VALUE_DTYPES:
        raise ValueError(f"unknown wire_value_dtype {val_dtype!r}; valid: {list(WIRE_VALUE_DTYPES)}")
    if val_dtype == "uint8" and cap is not None and cap % 2:
        raise ValueError(f"the uint8 wire packs values in pairs: cap must be even, got {cap}")


def _wire_hi_bits(D: int) -> int:
    return max(0, int(D + 1).bit_length() - 16)


def _wire_hi_words(D: int, cap: int) -> int:
    """uint32 words per row that hold the ids' bits above the low 16."""
    hi_bits = _wire_hi_bits(D)
    return 1 if hi_bits == 0 else -(-cap // (32 // hi_bits))


def _wire_value_words(val_dtype: str, cap: int) -> int:
    return {"float32": 2 * cap, "float16": cap, "bfloat16": cap, "uint8": cap // 2 + 1}[val_dtype]


def _wire_width(D: int, cap: int, val_dtype: str) -> int:
    """uint16 words a row of the wire buffer."""
    return cap + 2 * _wire_hi_words(D, cap) + _wire_value_words(val_dtype, cap)


def pack_query_ids(ids: np.ndarray, D: int) -> Tuple[np.ndarray, np.ndarray]:
    """Bit-pack padded (B, cap) int32 ids in [0, D+1]: returns (lo (B, cap)
    uint16, hi (B, nw) uint32).  Exact for any D < 2**31."""
    B, cap = ids.shape
    lo = (ids & 0xFFFF).astype(np.uint16)
    hi_bits = _wire_hi_bits(D)
    if hi_bits == 0:
        return lo, np.zeros((B, 1), np.uint32)
    per = 32 // hi_bits
    nw = _wire_hi_words(D, cap)
    hi = np.zeros((B, nw * per), np.uint32)
    hi[:, :cap] = ids.astype(np.uint32) >> np.uint32(16)
    shifts = np.arange(per, dtype=np.uint32) * np.uint32(hi_bits)
    return lo, np.bitwise_or.reduce(hi.reshape(B, nw, per) << shifts, axis=2)


def unpack_query_ids(lo: torch.Tensor, hi: torch.Tensor, D: int, cap: int) -> torch.Tensor:
    """Device-side inverse of :func:`pack_query_ids`.  ``lo`` (B, cap) int32
    holds the low 16 bits, ``hi`` (B, nw) int32 the packed words' bits.
    Returns (B, cap) int32 ids."""
    hi_bits = _wire_hi_bits(D)
    if hi_bits == 0:
        return lo
    per = 32 // hi_bits
    words = hi.repeat_interleave(per, dim=1)[:, :cap]
    shift = (torch.arange(cap, dtype=torch.int32, device=lo.device) % per) * hi_bits
    # an arithmetic shift of a word with its top bit set fills in sign bits,
    # but only bits below shift + hi_bits <= 32 survive the mask
    return lo | (((words >> shift) & ((1 << hi_bits) - 1)) << 16)


def encode_wire_batch(ids: np.ndarray, vals: np.ndarray, D: int, val_dtype: str = "float32") -> np.ndarray:
    """Host side: padded (B, cap) ids + float32 values -> one (B, width) uint16
    buffer, equal bit for bit to the JAX package's ``encode_wire_batch`` for
    every value but NaN.

    uint8: per row, step = float16(max(|v|, 1e-30) / 127) in float32 arithmetic
    and q = clip(rint(v / step), -127, 127).  A row whose step rounds to 0 (all
    zeros, as every pad row is, or |v| < ~3.8e-6) writes q = sign(v) * 127
    without dividing, the bytes the JAX encoder's 0/0 and v/0 leave on x86;
    such a row decodes to zeros either way.
    """
    B, cap = ids.shape
    check_wire_value_dtype(val_dtype, cap)
    lo, hi = pack_query_ids(ids, D)
    nw = hi.shape[1]
    voff = cap + 2 * nw
    buf = np.empty((B, _wire_width(D, cap, val_dtype)), np.uint16)
    buf[:, :cap] = lo
    buf[:, cap : cap + nw] = hi & np.uint32(0xFFFF)
    buf[:, cap + nw : voff] = hi >> np.uint32(16)
    vals = np.ascontiguousarray(vals, np.float32)
    if val_dtype == "float32":
        bits = vals.view(np.uint32)
        buf[:, voff : voff + cap] = bits & np.uint32(0xFFFF)
        buf[:, voff + cap :] = bits >> np.uint32(16)
    elif val_dtype == "float16":
        buf[:, voff:] = vals.astype(np.float16).view(np.uint16)
    elif val_dtype == "bfloat16":
        # torch rounds to nearest even, as ml_dtypes does (ml_dtypes is not a
        # dependency of the port)
        buf[:, voff:] = torch.from_numpy(vals).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    else:  # uint8
        scale = np.abs(vals).max(axis=1) if cap else np.zeros(B, np.float32)
        step = (np.maximum(scale, np.float32(1e-30)) / np.float32(127.0)).astype(np.float16)
        step32 = step.astype(np.float32)[:, None]
        nonzero = step32 > 0
        q = np.where(
            nonzero,
            np.clip(np.rint(vals / np.where(nonzero, step32, np.float32(1.0))), -127, 127),
            np.sign(vals) * np.float32(127.0),
        )
        qu = q.astype(np.int8).view(np.uint8)
        buf[:, voff : voff + cap // 2] = qu[:, 0::2] | (qu[:, 1::2].astype(np.uint16) << np.uint16(8))
        buf[:, voff + cap // 2] = step.view(np.uint16)
    return buf


def decode_wire_batch(buf: torch.Tensor, D: int, cap: int, val_dtype: str = "float32") -> Tuple[torch.Tensor, torch.Tensor]:
    """Device side: the wire buffer as an int16 tensor (torch's uint16 has
    few operators) -> (ids (B, cap) int32, vals (B, cap) float32), on the
    buffer's device.  Bit arithmetic runs in int32; float planes come back by
    reinterpreting the words."""
    check_wire_value_dtype(val_dtype, cap)
    nw = _wire_hi_words(D, cap)
    voff = cap + 2 * nw
    words = buf.to(torch.int32) & 0xFFFF
    # two 16-bit halves side by side (low first) read as one 32-bit word
    join = lambda lo16, hi16: torch.stack([lo16, hi16], dim=-1).view(torch.int32).squeeze(-1)
    ids = unpack_query_ids(words[:, :cap], join(buf[:, cap : cap + nw], buf[:, cap + nw : voff]), D, cap)
    if val_dtype == "float32":
        vals = join(buf[:, voff : voff + cap], buf[:, voff + cap :]).view(torch.float32)
    elif val_dtype in ("float16", "bfloat16"):
        vals = buf[:, voff:].view(getattr(torch, val_dtype)).to(torch.float32)
    else:  # uint8
        pairs = words[:, voff : voff + cap // 2]
        q = torch.stack([pairs & 0xFF, pairs >> 8], dim=-1).reshape(buf.shape[0], cap)
        q = (q ^ 0x80) - 0x80  # the bytes as signed int8
        step = buf[:, voff + cap // 2].view(torch.float16).to(torch.float32)
        vals = q.to(torch.float32) * step[:, None]
    return ids, vals


def score_candidates_dense_sparse(
    qids: torch.Tensor,  # (N, Qn) int32, pad id >= D+1 with val 0
    qvals: torch.Tensor,  # (N, Qn) float32
    layer: DeviceLayer,
    cand: torch.Tensor,  # (N, K) int64, in range
    bias_id: Optional[int] = None,
    bias_val: float = 0.0,
) -> torch.Tensor:
    """Dense-layout layer scored from sparse queries: a row gather of W and one
    contraction, scores[b, l] = sum_q qvals[b, q] * W[qids[b, q], l].  Padded
    qids clip onto the last row; their vals are 0 so they add nothing."""
    W = layer.W  # (D+1, L)
    Wg = W[qids.long().clamp(0, W.shape[0] - 1)]  # (N, Qn, L)
    scores_all = torch.einsum("bql,bq->bl", Wg, qvals)
    if bias_id is not None:
        scores_all = scores_all + bias_val * W[bias_id]
    return scores_all.gather(1, cand)


def score_candidates(X: torch.Tensor, layer: DeviceLayer, cand: torch.Tensor) -> torch.Tensor:
    """Raw scores x . w_l for candidate labels from dense queries X (N, D+1)."""
    if layer.kind == "dense":
        return (X @ layer.W).gather(1, cand)
    N, K = cand.shape
    rows = max(1, _GATHER_BLOCK_ELEMENTS // max(1, K * layer.packed.shape[1] // 2))
    out = []
    for s in range(0, N, rows):
        ids, vals = split_packed(layer.packed[cand[s : s + rows]])  # (n, K, P)
        n = ids.shape[0]
        xg = X[s : s + rows].gather(1, ids.reshape(n, -1).long()).reshape(ids.shape)
        out.append((xg * vals).sum(dim=-1))
    return torch.cat(out) if out else X.new_zeros((0, K))


def beam_step(
    X: Optional[torch.Tensor],
    layer: DeviceLayer,
    parents: torch.Tensor,  # (N, B) int64 node ids at the previous level (-1 invalid)
    pvals: torch.Tensor,  # (N, B) float32 combined path values
    k: int,
    pp: PostProcessor,
    no_prev: bool,
    qids: Optional[torch.Tensor] = None,
    qvals: Optional[torch.Tensor] = None,
    bias_id: Optional[int] = None,
    bias_val: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand parents through one layer; returns (labels (N, k), values (N, k)).

    A plabel layer scores sparse queries with K1 on its packed rows read by
    candidate id; a -1 candidate (a children-table pad) reads nothing and
    scores 0, and ``select_beam`` masks it."""
    cand, valid = expand_beam(layer.children, parents)
    if layer.kind == "plabel" and qids is not None:
        raw = intersect_scores_rows(qids, qvals, layer.packed, cand, bias_id, bias_val)
    elif layer.kind == "dense" and X is None:
        raw = score_candidates_dense_sparse(qids, qvals, layer, cand.clamp(0, layer.nr_labels - 1), bias_id, bias_val)
    else:
        raw = score_candidates(X, layer, cand.clamp(0, layer.nr_labels - 1))
    return select_beam(raw, cand, valid, pvals, k, pp, no_prev)


def expand_beam(children: torch.Tensor, parents: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The candidates of a beam: (the children (N, B*maxc) of each parent,
    clamped into the children table, with their -1 pads; whether each is
    valid, i.e. a real child of a live beam slot)."""
    N, B = parents.shape
    maxc = children.shape[1]
    cand = children[parents.clamp(0, children.shape[0] - 1)].reshape(N, B * maxc)
    valid = (cand >= 0) & (parents >= 0).repeat_interleave(maxc, dim=1)
    return cand, valid


def select_beam(
    raw: torch.Tensor,  # (N, B*maxc) raw scores of the candidates
    cand: torch.Tensor,
    valid: torch.Tensor,
    pvals: torch.Tensor,  # (N, B) path values of the beam
    k: int,
    pp: PostProcessor,
    no_prev: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Post-process raw candidate scores, combine them with the path values
    and keep the top k; returns (labels (N, k), values (N, k)), -1 labels for
    slots with no valid candidate."""
    val = pp.transform_torch(raw)
    if not no_prev:
        val = pp.combiner_torch(val, pvals.repeat_interleave(cand.shape[1] // pvals.shape[1], dim=1))
    val = torch.where(valid, val, NEG_INF)
    k = min(k, cand.shape[1])
    # jax.lax.top_k puts the lower index first among equal values; a stable
    # descending sort does the same, so ties (saturated hinges, masked slots)
    # break alike in both packages and on every device
    topv, topi = torch.sort(val, dim=1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    labels = cand.gather(1, topi)
    labels = torch.where(topv > NEG_INF * 0.5, labels, -1)
    return labels, topv


def root_beam(n_roots: int, N: int, pp_name: str, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The initial beam: every root-level cluster active for each of N queries."""
    parents = torch.arange(n_roots, dtype=torch.int64, device=device).repeat(N, 1)
    pvals = torch.full((N, n_roots), PostProcessor.get(pp_name).init_value, dtype=torch.float32, device=device)
    return parents, pvals


def chain_predict(
    X: Optional[torch.Tensor],
    layers: Sequence[DeviceLayer],
    beam_size: int,
    only_topk: int,
    pp_names: Tuple[str, ...],
    qids: Optional[torch.Tensor] = None,
    qvals: Optional[torch.Tensor] = None,
    bias_id: Optional[int] = None,
    bias_val: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-chain beam search.  Returns (labels (N, k), values (N, k)).

    X is the dense (N, D+1) query block for dense layers; (qids, qvals) the
    padded sparse form for plabel layers.  Either may be None when no layer
    needs it.  ``bias_id`` (the bias feature's column) lets sparse scoring add
    the bias term without widening every query row.  Level d's step runs in
    span ``pecos.level.<d>``.
    """
    ref = X if X is not None else qids
    parents, pvals = root_beam(layers[0].children.shape[0], ref.shape[0], pp_names[0], ref.device)
    for d, layer in enumerate(layers):
        k = only_topk if d == len(layers) - 1 else beam_size
        with span(f"pecos.level.{d}"):
            parents, pvals = beam_step(
                X, layer, parents, pvals, k, PostProcessor.get(pp_names[d]), no_prev=(d == 0),
                qids=qids, qvals=qvals, bias_id=bias_id, bias_val=bias_val,
            )
    return parents, pvals


def _pp_names(post_processor, depth: int) -> Tuple[str, ...]:
    """One post-processor name per layer, each validated with a clear error."""
    names = (post_processor,) * depth if isinstance(post_processor, str) else tuple(post_processor)
    for name in names:
        PostProcessor.get(name)
    return names


def _check_features(X, nr_features: int) -> None:
    if X.shape[1] != nr_features:
        raise ValueError(
            f"Feature dimension of query matrix ({X.shape[1]}) does not match "
            f"weight matrix ({nr_features})"
        )


def _fetch_topk(pending, k: int, nr_labels: int) -> smat.csr_matrix:
    """One device->host copy of per-batch (labels, values) -> top-k CSR."""
    if pending:
        labels = torch.cat([l for l, _ in pending]).cpu().numpy()
        vals = torch.cat([v for _, v in pending]).cpu().numpy()
    else:
        labels, vals = np.zeros((0, k), np.int64), np.zeros((0, k), np.float32)
    return smat_util.csr_from_topk_arrays(labels, vals, nr_labels)


def densifies_queries(batch: int, D: int, cap: int, layers: Sequence[DeviceLayer]) -> bool:
    """Whether sparse queries of ``batch`` rows (``cap`` nonzeros each, D
    features) are densified on the device for the dense ``layers`` (the rule
    of the JAX package's ``_sparse_predictor``).

    Dense layers score from the sparse queries by a W-row gather when the
    densified (batch, D+2) block would be large; for small D the scatter is
    cheap.  A dense layer too wide for the gather intermediate also forces
    the scatter."""
    return any(l.kind == "dense" for l in layers) and (
        batch * (D + 2) <= (1 << 26)
        or any(l.kind == "dense" and batch * cap * l.nr_labels > (1 << 28) for l in layers)
    )


class CompiledHierModel:
    """Device-resident hierarchical model: the layers of one chain on one
    torch device, and the batched beam-search predict over them."""

    def __init__(self, layers: List[DeviceLayer], bias: float, nr_features: int):
        devices = {l.device for l in layers}
        if len(devices) != 1:
            raise ValueError(f"all layers must be on one device, got {sorted(map(str, devices))}")
        self.layers = layers
        self.bias = bias
        self.nr_features = nr_features
        self.device = devices.pop()
        # parallel.mesh: this model's layers padded and placed on a mesh, by
        # (mesh devices, engine), built once and reused by every sharded predict
        self.mesh_layers: Dict[tuple, object] = {}

    @classmethod
    def from_host_chain(
        cls,
        Ws: Sequence[smat.spmatrix],
        Cs: Sequence[smat.spmatrix],
        bias: float,
        *,
        layouts: Optional[Sequence[Optional[str]]] = None,
        device: DeviceLike = "cuda",
    ) -> "CompiledHierModel":
        layouts = layouts if layouts is not None else [None] * len(Ws)
        layers = [
            build_device_layer(W, C, layout=lo, device=device) for W, C, lo in zip(Ws, Cs, layouts)
        ]
        return cls(layers, bias, Ws[0].shape[0] - (1 if bias > 0 else 0))

    @property
    def nr_labels(self) -> int:
        return self.layers[-1].nr_labels

    @property
    def depth(self) -> int:
        return len(self.layers)

    def uses_dense_queries(self, batch: int, cap: int) -> bool:
        """Whether sparse queries of this batch are densified on the device for
        the dense layers (``densifies_queries``)."""
        return densifies_queries(batch, self.nr_features, cap, self.layers)

    def predict_padded(
        self,
        ids: torch.Tensor,
        vals: torch.Tensor,
        *,
        beam_size: int,
        only_topk: int,
        pp_names: Tuple[str, ...],
        has_dense: bool,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Beam search for one batch of padded sparse queries already on the
        device; returns (labels, values) on the device."""
        D = self.nr_features
        use_sparse_q = any(l.kind == "plabel" for l in self.layers) or not has_dense
        X = scatter_queries(ids, vals, D, self.bias) if has_dense else None
        return chain_predict(
            X, self.layers, beam_size, only_topk, pp_names,
            qids=ids if use_sparse_q else None,
            qvals=vals if use_sparse_q else None,
            bias_id=D if self.bias > 0 else None,
            bias_val=self.bias,
        )

    def queries_to_device(
        self, ids: np.ndarray, vals: np.ndarray, wire_value_dtype: str = "float32"
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Padded host queries -> (ids int32, vals float32) on the device.
        "float32" uploads them as they are, which equals the float32 wire bit
        for bit; any other wire dtype uploads one encoded buffer and decodes it
        on the device."""
        if wire_value_dtype == "float32":
            return _upload(ids, self.device), _upload(vals, self.device)
        buf = encode_wire_batch(ids, vals, self.nr_features, wire_value_dtype)
        return decode_wire_batch(_upload(buf.view(np.int16), self.device), self.nr_features, ids.shape[1], wire_value_dtype)

    def predict(
        self,
        X,
        *,
        beam_size: int = 10,
        only_topk: int = 20,
        post_processor="l3-hinge",
        batch_size: int = 1024,
        wire_value_dtype: str = "float32",
    ) -> smat.csr_matrix:
        """Host-facing predict: any X (sparse/dense) -> sorted top-k CSR.

        ``post_processor`` is one name for every layer or a tuple of per-layer
        names.  Sparse queries travel on the ``wire_value_dtype`` wire:
        "float32" (exact), "float16" or "bfloat16" (values rounded to 11 or 8
        mantissa bits) or "uint8" (a per-row step); ids are exact on every
        wire.  A sparse batch on the float32 wire is uploaded as its CSR slice
        and padded on the device; on the packed wires, and for dense X, it is
        padded on the host.  Uploads go from pinned memory without blocking;
        results stay on the device until one concatenation and one copy to
        the host at the end.

        The call runs in span ``pecos.predict``; each batch's padding,
        upload and beam walk in ``pecos.pad``, ``pecos.upload`` and
        ``pecos.walk`` (a batch padded on the device enters ``pecos.pad``
        twice: the slice on the host, the padding's launches after the
        upload), the fetch in ``pecos.fetch``.  Counters: ``pecos.batches``,
        and for sparse batches ``pecos.pad.device`` (batches padded on the
        device), ``pecos.upload_bytes`` (query bytes copied to the device),
        ``pecos.query_nnz`` (real nonzeros) and ``pecos.query_slots`` (slots
        of the padded block the walk reads); on a card, after the fetch,
        ``pecos.k1.passes`` and ``pecos.k1.chunks`` (``take_pass_counts``:
        the query chunks whose rows K1's blocks read, of the chunks they had,
        since the last take).
        """
        with span("pecos.predict"):
            check_wire_value_dtype(wire_value_dtype)
            _check_features(X, self.nr_features)
            pp_names = _pp_names(post_processor, self.depth)
            N = X.shape[0]
            batch = min(batch_size, max(1, 1 << max(N - 1, 0).bit_length()))
            D = self.nr_features
            pending = []
            if smat.issparse(X):
                A = X.tocsr()
                cap = query_cap(A)
                has_dense = self.uses_dense_queries(batch, cap)
                # the packed wires encode the host-padded block; the float32
                # wire's block is the CSR slice's, built where it is read
                on_device = wire_value_dtype == "float32"
                for s in range(0, N, batch):
                    e = min(s + batch, N)
                    if on_device:
                        with span("pecos.pad"):
                            rows = csr_rows(A, s, e)
                        with span("pecos.upload"):
                            rows_d = [_upload(a, self.device) for a in rows]
                        with span("pecos.pad"):
                            qids, qvals = pad_csr_on_device(*rows_d, batch, cap, D)
                        nbytes = sum(a.nbytes for a in rows)
                    else:
                        with span("pecos.pad"):
                            ids, vals = pad_query_rows(*prepare_queries_padded(A[s:e], cap=cap), batch, D)
                        with span("pecos.upload"):
                            qids, qvals = self.queries_to_device(ids, vals, wire_value_dtype)
                        nbytes = 2 * batch * _wire_width(D, cap, wire_value_dtype)
                    count("pecos.batches")
                    count("pecos.pad.device", on_device)
                    count("pecos.upload_bytes", nbytes)
                    count("pecos.query_nnz", A.indptr[e] - A.indptr[s])
                    count("pecos.query_slots", batch * cap)
                    with span("pecos.walk"):
                        labels, scores = self.predict_padded(
                            qids, qvals, beam_size=beam_size, only_topk=only_topk, pp_names=pp_names,
                            has_dense=has_dense,
                        )
                    pending.append((labels[: N - s], scores[: N - s]))
            else:
                for s in range(0, N, batch):
                    with span("pecos.pad"):
                        xb = prepare_queries(X[s : s + batch], self.bias)
                        if xb.shape[0] < batch:
                            xb = np.vstack([xb, np.zeros((batch - xb.shape[0], xb.shape[1]), np.float32)])
                    with span("pecos.upload"):
                        xb = _upload(xb, self.device)
                    count("pecos.batches")
                    with span("pecos.walk"):
                        labels, scores = chain_predict(xb, self.layers, beam_size, only_topk, pp_names)
                    pending.append((labels[: N - s], scores[: N - s]))
            with span("pecos.fetch"):
                out = _fetch_topk(pending, only_topk, self.nr_labels)
            # the fetch has waited for the card, so K1's pass count is final
            passes = take_pass_counts(self.device)
            if passes is not None:
                count("pecos.k1.passes", passes[0])
                count("pecos.k1.chunks", passes[1])
            return out

    def realtime_session(self, **kwargs) -> "RealtimeSession":
        """Open a persistent low-latency predict session (see RealtimeSession)."""
        return RealtimeSession(self, **kwargs)


# the card sleeps this many times the host's measured enqueue of one call, plus
# a millisecond, while the host queues the call that is timed
_SLEEP_MARGIN = 4
_SLEEP_RETRIES = 4
_SLEEP_CALIBRATION_CYCLES = 1 << 24


def _device_ms_per_call(step, state, iters: int) -> float:
    """Mean device milliseconds of ``iters`` chained calls ``state =
    step(state)`` on the current CUDA device, each between two CUDA events
    queued behind a sleep of the card.

    An eager call is many small launches: between two events recorded around
    it, the card would wait on the host's launches, so the interval would be
    the host's time.  Here the card sleeps (``torch.cuda._sleep``) while the
    host queues the whole call, and then runs it back to back.  The sleep is
    sized from a measured host enqueue of one call; one call is timed at a
    time, because the launch queue holds about a thousand kernels, fewer than
    many chained calls.  A call whose enqueue outlasted the sleep it was
    queued behind (measured by an event before the sleep) is timed again
    behind twice the sleep; after _SLEEP_RETRIES such doublings the call
    must be waiting on the card itself (a host sync), and this raises."""
    timer = lambda: torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(state)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    a, b = timer(), timer()
    a.record()
    torch.cuda._sleep(_SLEEP_CALIBRATION_CYCLES)
    b.record()
    b.synchronize()
    cycles_per_ms = _SLEEP_CALIBRATION_CYCLES / a.elapsed_time(b)
    sleep_ms = _SLEEP_MARGIN * enqueue_ms + 1.0
    total = 0.0
    for _ in range(iters):
        for _ in range(_SLEEP_RETRIES + 1):
            before, start, end = timer(), timer(), timer()
            t0 = time.perf_counter()
            before.record()
            torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
            start.record()
            nxt = step(state)
            end.record()
            queued_ms = (time.perf_counter() - t0) * 1e3
            end.synchronize()
            if queued_ms < before.elapsed_time(start):
                break
            sleep_ms *= 2
        else:
            raise RuntimeError(f"the timed call took {queued_ms!r} ms to queue behind a {sleep_ms / 2!r} ms sleep: it waits on the card")
        total += start.elapsed_time(end)
        state = nxt
    return total / iters


class RealtimeSession:
    """Persistent low-latency predict session over a compiled model.

    Opening validates the settings and makes one warm call.  Each
    ``predict`` of up to ``batch`` query rows is one upload of a wire buffer
    (through a pinned staging buffer the session owns), one beam walk and one
    fetch of labels and scores together.  ``on_device_latency_ms`` times the
    beam walk alone.
    """

    def __init__(
        self,
        model: CompiledHierModel,
        *,
        beam_size: int = 10,
        only_topk: int = 20,
        post_processor="l3-hinge",
        batch: int = 1,
        cap: int = 64,
        wire_value_dtype: str = "float32",
    ):
        self.model = model
        self.batch = int(batch)
        self.cap = int(cap)
        if self.batch < 1 or self.cap < 1:
            raise ValueError(f"batch and cap must be >= 1, got batch={batch}, cap={cap}")
        check_wire_value_dtype(wire_value_dtype, self.cap)
        self.beam_size = beam_size
        self.only_topk = only_topk
        self.wire_value_dtype = wire_value_dtype
        self.pp_names = _pp_names(post_processor, model.depth)
        self._has_dense = model.uses_dense_queries(self.batch, self.cap)
        D = model.nr_features
        # a batch of empty rows: sizes the staging buffers and warms the walk
        empty = np.full((self.batch, self.cap), D + 1, np.int32), np.zeros((self.batch, self.cap), np.float32)
        warm = encode_wire_batch(*empty, D, wire_value_dtype)
        pinned = model.device.type == "cuda"
        self._host = torch.empty(warm.shape, dtype=torch.int16, pin_memory=pinned)
        self._dev = torch.empty(warm.shape, dtype=torch.int16, device=model.device)
        self._run(warm)

    def _walk(self, ids: torch.Tensor, vals: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.model.predict_padded(
            ids, vals, beam_size=self.beam_size, only_topk=self.only_topk,
            pp_names=self.pp_names, has_dense=self._has_dense,
        )

    def _run(self, buf: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Upload one wire buffer, walk, fetch: (labels int32, scores float32)."""
        # the previous call's fetch waited for its upload, so the staging
        # buffer is free to overwrite
        self._host.numpy()[...] = buf.view(np.int16)
        self._dev.copy_(self._host, non_blocking=True)
        labels, scores = self._walk(*decode_wire_batch(self._dev, self.model.nr_features, self.cap, self.wire_value_dtype))
        out = torch.stack([labels.to(torch.int32), scores.view(torch.int32)]).cpu().numpy()
        return out[0], out[1].view(np.float32)

    def _padded(self, X, what: str) -> Tuple[np.ndarray, np.ndarray, int]:
        """Validated padded (batch, cap) ids/values of X's first rows and their count."""
        A = X.tocsr() if smat.issparse(X) else smat.csr_matrix(np.asarray(X, np.float32))
        _check_features(A, self.model.nr_features)
        if A.shape[0] > self.batch:
            raise ValueError(f"session batch is {self.batch}, got {A.shape[0]} rows")
        if A.shape[0] and int(np.diff(A.indptr).max()) > self.cap:
            raise ValueError(
                f"{what}: a query has more nonzeros than the session cap ({self.cap}); "
                "open the session with a larger cap"
            )
        ids, vals = pad_query_rows(*prepare_queries_padded(A, cap=self.cap), self.batch, self.model.nr_features)
        return ids, vals, A.shape[0]

    def predict(self, X) -> smat.csr_matrix:
        """Top-k CSR for up to ``batch`` query rows (CSR or dense)."""
        ids, vals, n = self._padded(X, "predict")
        labels, scores = self._run(encode_wire_batch(ids, vals, self.model.nr_features, self.wire_value_dtype))
        return smat_util.csr_from_topk_arrays(labels[:n].astype(np.int64), scores[:n], self.model.nr_labels)

    def on_device_latency_ms(self, X=None, iters: int = 32) -> float:
        """Milliseconds per beam walk of one session batch, the host's upload
        and fetch left out: ``iters`` walks chained on the device (each shifts
        the query ids by the previous walk's top label mod 7, a tensor, so the
        walks run strictly in turn and the host never waits), timed on a GPU
        by CUDA events around each walk queued behind a sleep of the card
        (:func:`_device_ms_per_call`), so the time is the card's and not the
        host's launches, and by the host clock on the CPU.  X defaults to
        random queries with ``cap`` nonzeros; its first ``batch`` rows are
        used, and a row with more than ``cap`` nonzeros raises."""
        if iters < 1:
            raise ValueError(f"iters must be >= 1, got {iters}")
        model = self.model
        D = model.nr_features
        if X is not None:
            A = X.tocsr() if smat.issparse(X) else smat.csr_matrix(np.asarray(X, np.float32))
            ids, vals, _ = self._padded(A[: self.batch], "on_device_latency_ms")
        else:
            rng = np.random.default_rng(0)
            ids = np.sort(rng.integers(0, D, size=(self.batch, self.cap), dtype=np.int32), axis=1)
            vals = rng.standard_normal((self.batch, self.cap)).astype(np.float32) * 0.1
        ids_d, vals_d = model.queries_to_device(ids, vals, self.wire_value_dtype)

        def walk(qids):
            labels, _ = self._walk(qids, vals_d)
            shift = (labels[0, 0] % 7).to(torch.int32)
            return torch.where(qids >= D + 1, qids, (qids + shift) % D)

        walk(ids_d)  # warm: every shape allocated, so no walk waits on the allocator
        qids = ids_d
        if model.device.type == "cuda":
            with torch.cuda.device(model.device):
                return _device_ms_per_call(walk, qids, iters)
        t0 = time.perf_counter()
        for _ in range(iters):
            qids = walk(qids)
        return (time.perf_counter() - t0) * 1000.0 / iters


# ---------------------------------------------------------------------------
# single-layer predict (MLModel.predict / csr_codes path) and selected labels
# ---------------------------------------------------------------------------


def score_selected_labels(
    layer: DeviceLayer, X, bias: float, labels_padded: np.ndarray, batch_size: int = 1024
) -> np.ndarray:
    """Raw scores x . w_l for explicit padded (N, cap) label ids (-1 = pad,
    scored as label 0): dense queries, ``batch_size`` rows at a time."""
    Xd = prepare_queries(X, bias)
    out = []
    for s in range(0, Xd.shape[0], batch_size):
        cand = _upload(np.ascontiguousarray(labels_padded[s : s + batch_size], np.int64), layer.device)
        out.append(score_candidates(_upload(Xd[s : s + batch_size], layer.device), layer, cand.clamp(0, layer.nr_labels - 1)))
    if not out:
        return np.zeros((0, labels_padded.shape[1]), np.float32)
    return torch.cat(out).cpu().numpy()


def _beam_from_codes(csr_codes: smat.spmatrix, N: int) -> Tuple[np.ndarray, np.ndarray]:
    """A previous layer's CSR predictions as a padded beam: (parents int64 with
    -1 pads, path values float32), each (N, max row nnz) with at least one column."""
    codes = csr_codes.tocsr()
    counts = np.diff(codes.indptr)
    width = max(int(counts.max()) if N else 1, 1)
    parents = np.full((N, width), -1, np.int64)
    pvals = np.zeros((N, width), np.float32)
    rows = np.repeat(np.arange(N), counts)
    offs = np.arange(codes.nnz) - np.repeat(codes.indptr[:-1], counts)
    parents[rows, offs] = codes.indices
    pvals[rows, offs] = codes.data
    return parents, pvals


def single_layer_predict(
    layer: DeviceLayer,
    X,
    bias: float,
    csr_codes: Optional[smat.spmatrix],
    only_topk: int,
    post_processor: str,
    batch_size: int = 1024,
) -> smat.csr_matrix:
    """One-layer predict: candidates are the children of the clusters active
    in ``csr_codes`` (every cluster if None), and values combine with the
    codes' values unless ``csr_codes`` is None.

    Sparse X travels as padded (ids, values) a batch at a time: a plabel
    layer scores it with K1, a dense layer by a W-row gather or, by
    ``densifies_queries``' rule, a batch densified on the device.  Dense X
    is one dense block.  (The JAX package densifies every
    X on the host: 64 GB for XR-Transformer's 20,000 x 800,000 X_cat.)"""
    N = X.shape[0]
    pp = PostProcessor.get(post_processor)
    dev = layer.device
    if csr_codes is None:
        parents, pvals = root_beam(layer.children.shape[0], N, post_processor, dev)
    else:
        parents, pvals = (_upload(a, dev) for a in _beam_from_codes(csr_codes, N))
    k = min(only_topk, parents.shape[1] * layer.max_children)
    if smat.issparse(X):
        ids, vals = prepare_queries_padded(X)
        D = X.shape[1]
        scatter = densifies_queries(batch_size, D, ids.shape[1], [layer])

        def step(s):
            qi, qv = _upload(ids[s : s + batch_size], dev), _upload(vals[s : s + batch_size], dev)
            return beam_step(
                scatter_queries(qi, qv, D, bias) if scatter else None, layer, parents[s : s + batch_size],
                pvals[s : s + batch_size], k, pp, no_prev=csr_codes is None, qids=qi, qvals=qv,
                bias_id=D if bias > 0 else None, bias_val=bias,
            )
    else:
        Xd = prepare_queries(X, bias)

        def step(s):
            return beam_step(_upload(Xd[s : s + batch_size], dev), layer, parents[s : s + batch_size],
                             pvals[s : s + batch_size], k, pp, no_prev=csr_codes is None)

    return _fetch_topk([step(s) for s in range(0, N, batch_size)], k, layer.nr_labels)


# ---------------------------------------------------------------------------
# compiled layers on disk, and the streaming model over them
# ---------------------------------------------------------------------------


def save_compiled_layers(layers: Sequence[DeviceLayer], bias: float, nr_features: int, folder: str) -> None:
    """Write device layouts for predict-only loading, in the JAX package's
    format: ``compiled.json`` (bias, nr_features, each layer's kind and
    nr_labels) and ``layer_{d}.npz`` with ``children`` int32 and ``W``
    (dense) or ``packed`` (plabel)."""
    os.makedirs(folder, exist_ok=True)
    meta = {"bias": bias, "nr_features": nr_features, "layers": []}
    for d, layer in enumerate(layers):
        arrays = {"children": layer.children.cpu().numpy().astype(np.int32)}
        if layer.kind == "dense":
            arrays["W"] = layer.W.cpu().numpy()
        else:
            arrays["packed"] = layer.packed.cpu().numpy()
        np.savez(os.path.join(folder, f"layer_{d}.npz"), **arrays)
        meta["layers"].append({"kind": layer.kind, "nr_labels": layer.nr_labels})
    with open(os.path.join(folder, "compiled.json"), "w") as f:
        json.dump(meta, f)


def _layer_from_npz(path: str, kind: str, nr_labels: int, device: DeviceLike) -> DeviceLayer:
    """One ``layer_{d}.npz`` on ``device``."""
    weights = "W" if kind == "dense" else "packed"
    with np.load(path) as z:
        arrays = {"kind": kind, "nr_labels": nr_labels, "children": z["children"], weights: z[weights]}
    return layers_from_numpy([arrays], device)[0]


class LazyLayerHandle:
    """A compiled layer left on disk; ``to_device`` reads and uploads it."""

    def __init__(self, folder: str, d: int, kind: str, nr_labels: int):
        self.path = os.path.join(folder, f"layer_{d}.npz")
        self.kind = kind
        self.nr_labels = nr_labels

    @property
    def nbytes(self) -> int:
        """The layer file's size, what the resident budget counts."""
        return os.path.getsize(self.path)

    def to_device(self, device: DeviceLike) -> DeviceLayer:
        return _layer_from_npz(self.path, self.kind, self.nr_labels, device)


def load_compiled_layers(
    folder: str, lazy: bool = False, resident_budget_bytes: int = 2 << 30, device: DeviceLike = "cuda"
):
    """Load a compiled folder onto ``device``: a :class:`CompiledHierModel`
    with every layer resident, or with ``lazy=True`` a
    :class:`MmapCompiledHierModel` that keeps the front layers fitting
    ``resident_budget_bytes`` resident and streams the others per predict."""
    with open(os.path.join(folder, "compiled.json")) as f:
        meta = json.load(f)
    handles = [LazyLayerHandle(folder, d, lm["kind"], lm["nr_labels"]) for d, lm in enumerate(meta["layers"])]
    if lazy:
        return MmapCompiledHierModel(
            handles, meta["bias"], meta["nr_features"], resident_budget_bytes=resident_budget_bytes, device=device
        )
    return CompiledHierModel([h.to_device(device) for h in handles], meta["bias"], meta["nr_features"])


class MmapCompiledHierModel:
    """Predict-only model whose layers stay on disk and stream to the device.

    The beam search runs level-major: each streamed level's layer is uploaded
    once per predict call, every query batch steps through it, and it is
    freed before the next level's upload, so device memory holds one streamed
    layer at a time besides the query blocks and beams.  The front layers that
    fit ``resident_budget_bytes`` (counted in file bytes) stay resident across
    calls.  Queries are scored dense, as by ``single_layer_predict``.
    """

    def __init__(
        self,
        handles: Sequence[LazyLayerHandle],
        bias: float,
        nr_features: int,
        resident_budget_bytes: int = 2 << 30,
        device: DeviceLike = "cuda",
    ):
        self.handles = list(handles)
        self.bias = bias
        self.nr_features = nr_features
        self.device = resolve_device(device)
        self._resident: Dict[int, DeviceLayer] = {}
        used = 0
        for d, h in enumerate(self.handles):
            if used + h.nbytes > resident_budget_bytes:
                break
            self._resident[d] = h.to_device(self.device)
            used += h.nbytes

    @property
    def nr_labels(self) -> int:
        return self.handles[-1].nr_labels

    @property
    def depth(self) -> int:
        return len(self.handles)

    def predict(
        self,
        X,
        *,
        beam_size: int = 10,
        only_topk: int = 20,
        post_processor="l3-hinge",
        batch_size: int = 1024,
    ) -> smat.csr_matrix:
        _check_features(X, self.nr_features)
        pp_names = _pp_names(post_processor, self.depth)
        Xd = prepare_queries(X, self.bias)
        X_blocks = [_upload(Xd[s : s + batch_size], self.device) for s in range(0, Xd.shape[0], batch_size)]
        beams: List[Optional[Tuple[torch.Tensor, torch.Tensor]]] = [None] * len(X_blocks)
        for d in range(self.depth):
            layer = self._resident[d] if d in self._resident else self.handles[d].to_device(self.device)
            pp = PostProcessor.get(pp_names[d])
            k = only_topk if d == self.depth - 1 else beam_size
            for i, xb in enumerate(X_blocks):
                parents, pvals = beams[i] if d else root_beam(layer.children.shape[0], xb.shape[0], pp_names[0], self.device)
                beams[i] = beam_step(xb, layer, parents, pvals, k, pp, no_prev=(d == 0))
            del layer  # a streamed layer goes back to the allocator before the next level's upload
        return _fetch_topk(beams, only_topk, self.nr_labels)
