"""K1: sparse-query x sparse-weight id-intersection scoring.

The hot loop of XR-Linear beam-search predict: every plabel layer scores its
beam's candidate labels with it; the sparse HNSW search and selection score
neighbours with it.  It replaces the Pallas TPU kernel
``pecos_tpu/ops/intersect.py:intersect_scores_pallas``; the CUDA source and a
note on what bounds it on the card are in ``csrc/intersect.cu``.

Two entry points, one kernel:

- ``intersect_scores_rows(qids, qvals, table, rows)`` scores candidate (n, k)
  against row ``rows[n, k]`` of a packed table read in place (row -1 scores 0),
  so no gathered (N, K, 2P) block is built;
- ``intersect_scores(qids, qvals, w_packed)`` scores an already gathered
  (N, K, 2P) block.

Each chooses by the device of its tensors: CPU tensors go to the plain
PyTorch version; CUDA tensors go to the CUDA kernel, or the call raises.
There is no other switch.  Both count the kernel's launches in
``intersect_scores.launches``.

A query longer than one hash table is staged in chunks, and the kernel reads
its candidate rows once for the first chunk and once for each later chunk
that holds a nonzero: at most ``LaunchPlan.chunks`` passes a block.
``take_pass_counts`` says how many, of how many chunks, per device: the card
counts the passes past each block's first, the wrapper the rest; the plain
version counts nothing.

Numerical contract (that of ``pecos_tpu/xmc/inference.py:_intersect_scores``):
the matched-value sum is exact (CSR ids are unique per row, so each weight slot
matches at most one query nonzero); only the order of the final P-sum (and of
a repeated query id's values) differs between the kernel and the plain
version.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import _build

# query nonzeros compared per step of the plain version: an unchunked
# (N, K, P, Qn) compare block is ~2.7e9 elements at the predict path's shape
_REF_QUERY_CHUNK = 64

# the kernel's launch geometry (csrc/intersect.cu: kThreads; a test holds
# this and _CANDS equal to the kernel's constants)
_THREADS = 256
# query nonzeros hashed into shared memory at a time, into a table of 8x as
# many slots (a load of 1/8 keeps most probes to one read), 8 bytes a slot:
# 32 KB at most, with the block's row offsets (8 bytes each, at most
# _MAX_PER_BLOCK) under the 48 KB a launch may take without cudaFuncSetAttribute
_MAX_CHUNK = 512
_SLOTS_PER_ENTRY = 8
_MIN_SLOTS = 64
_MAX_PER_BLOCK = 512
# blocks a launch aims for before it spreads one query's candidates thinner:
# one wave of 8 blocks on each of an H100's 132 SMs
_TARGET_BLOCKS = 8 * 132
# waves a launch of queries longer than one chunk spreads over, at _CANDS
# candidates a group or more (csrc/intersect.cu: kCands, the candidates a
# group loads before probing).  A block's time follows the chunks of its
# query that hold a nonzero (1 to 8 passes over its rows at Qn 4,096), so
# one wave ends on the blocks of the longest queries;
# four waves of smaller blocks even them out (wiki500k-batch's label level,
# N 1,024, K 620: 2.09 ms at one wave, 1.50 ms at four, on an H100 at 700 W)
_LONG_QUERY_WAVES = 4
_CANDS = 2


class _PassCount:
    """K1's passes on one card: ``card``, the int64 its launches add their
    passes past each block's first to (``taken``: its reading at the last
    take_pass_counts), and, since that take, the blocks' first passes and the
    chunks they had, counted on the host."""

    __slots__ = ("card", "taken", "first", "chunks")

    def __init__(self, device: torch.device):
        self.card = torch.zeros(1, dtype=torch.int64, device=device)
        self.taken = self.first = self.chunks = 0


# per CUDA device, made at its first launch
_PASSES: Dict[torch.device, _PassCount] = {}


def split_packed(w_packed: torch.Tensor):
    """(…, 2P) int32 [ids | float bits] -> (ids (…, P) int32, vals (…, P) float32) views."""
    P = w_packed.shape[-1] // 2
    return w_packed[..., :P], w_packed[..., P:].view(torch.float32)


def intersect_scores_reference(
    qids: torch.Tensor,  # (N, Qn) int32; pad id any value with qval 0
    qvals: torch.Tensor,  # (N, Qn) float32
    w_packed: torch.Tensor,  # (N, K, 2P) int32 [ids | float bits]; pad slots id 0, value 0
    bias_id: Optional[int] = None,
    bias_val: float = 0.0,
) -> torch.Tensor:
    """Plain PyTorch K1: scores[n, k] = sum_p wv[n,k,p] * qval_match(wi[n,k,p])
    (+ bias_val * sum_p wv[n,k,p] * [wi[n,k,p] == bias_id]).  Returns (N, K) float32."""
    wi, wv = split_packed(w_packed)
    N, K, P = wi.shape
    g = torch.zeros((N, K, P), dtype=torch.float32, device=wi.device)
    for q0 in range(0, qids.shape[1], _REF_QUERY_CHUNK):
        qi = qids[:, None, None, q0 : q0 + _REF_QUERY_CHUNK]
        qv = qvals[:, None, None, q0 : q0 + _REF_QUERY_CHUNK]
        g += torch.where(qi == wi[..., None], qv, 0.0).sum(dim=-1)
    out = (g * wv).sum(dim=-1)
    if bias_id is not None:
        out = out + bias_val * torch.where(wi == bias_id, wv, 0.0).sum(dim=-1)
    return out


def intersect_scores_rows_reference(
    qids: torch.Tensor,  # (N, Qn) int32
    qvals: torch.Tensor,  # (N, Qn) float32
    table: torch.Tensor,  # (R, 2P) int32 [ids | float bits]
    rows: torch.Tensor,  # (N, K) int64 in [-1, R); -1 scores 0
    bias_id: Optional[int] = None,
    bias_val: float = 0.0,
) -> torch.Tensor:
    """Plain PyTorch K1 by row id: the rows gathered (a -1 row as all zeros),
    then ``intersect_scores_reference``.  Returns (N, K) float32."""
    w = table[rows.clamp(min=0)]
    w = torch.where((rows >= 0)[..., None], w, 0)
    return intersect_scores_reference(qids, qvals, w, bias_id, bias_val)


class LaunchPlan(NamedTuple):
    """How one K1 launch covers its work (csrc/intersect.cu)."""

    slots: int  # hash table slots, a power of two >= 8 x chunk
    chunk: int  # query nonzeros staged per table
    chunks: int  # tables built, and passes over the rows at most, per block: ceil(Qn / chunk)
    lanes: int  # lanes per candidate row, a power of two <= 32
    per_block: int  # candidates a block
    blocks_per_row: int  # blocks of one query
    grid: int  # blocks: N x blocks_per_row
    shared_bytes: int  # dynamic shared memory a block: the table, then the row offsets


def _launch_plan(N: int, K: int, P: int, Qn: int) -> LaunchPlan:
    """The launch geometry of K1 for N queries of Qn nonzeros, K candidates
    each, rows of P slots.  One block stages one query's nonzeros in a hash
    table (chunks of at most _MAX_CHUNK) and scores a run of its candidates;
    a group of ``lanes`` lanes reads one candidate's row, two slots a lane,
    so rows of 64 or more slots take a warp each.  A query's K candidates
    are split over as many blocks as bring the launch near _TARGET_BLOCKS,
    never fewer than one candidate a group and never more than
    _MAX_PER_BLOCK a block, so a single query still covers K / (threads /
    lanes) blocks.  Queries of more than one chunk are split further, over
    up to _LONG_QUERY_WAVES times as many blocks but no fewer than _CANDS
    candidates a group: their blocks make 1 to ``chunks`` passes."""
    chunk = max(1, min(Qn, _MAX_CHUNK))
    chunks = max(1, -(-Qn // chunk))
    slots = max(_MIN_SLOTS, 1 << math.ceil(math.log2(_SLOTS_PER_ENTRY * chunk)))
    lanes = min(32, 1 << math.ceil(math.log2(max(1, -(-P // 2)))))
    groups = _THREADS // lanes
    blocks_per_row = min(-(-K // groups), max(-(-_TARGET_BLOCKS // max(N, 1)), -(-K // _MAX_PER_BLOCK)))
    if chunks > 1:
        spread = min(-(-K // (_CANDS * groups)), -(-_LONG_QUERY_WAVES * _TARGET_BLOCKS // max(N, 1)))
        blocks_per_row = max(blocks_per_row, spread)
    blocks_per_row = max(1, blocks_per_row)
    per_block = max(1, -(-K // blocks_per_row))
    blocks_per_row = max(1, -(-K // per_block))
    grid = N * blocks_per_row if N and K else 0
    return LaunchPlan(slots, chunk, chunks, lanes, per_block, blocks_per_row, grid, 8 * (slots + per_block))


def _check_tensors(qids, qvals, *named):
    """Device, dtype, rank and contiguity of the kernel's tensor arguments:
    qids, qvals and each (name, tensor, dtype, ndim) of ``named``."""
    dev = qids.device
    for name, t, dtype, ndim in (("qids", qids, torch.int32, 2), ("qvals", qvals, torch.float32, 2), *named):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, qids on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    N, Qn = qids.shape
    if qvals.shape != (N, Qn):
        raise ValueError(f"qvals shape {tuple(qvals.shape)} != qids shape {(N, Qn)}")
    return N, Qn


def _check_plan(N, K, P, Qn):
    plan = _launch_plan(N, K, P, Qn)
    if plan.grid > 2**31 - 1:
        raise ValueError(f"grid too large for N={N}, K={K}")


def _check_cuda_args(qids, qvals, w_packed):
    N, Qn = _check_tensors(qids, qvals, ("w_packed", w_packed, torch.int32, 3))
    if w_packed.shape[0] != N or w_packed.shape[2] % 2:
        raise ValueError(f"w_packed must be (N={N}, K, 2P), got {tuple(w_packed.shape)}")
    _check_plan(N, w_packed.shape[1], w_packed.shape[2] // 2, Qn)


def _check_rows_args(qids, qvals, table, rows):
    N, Qn = _check_tensors(qids, qvals, ("table", table, torch.int32, 2), ("rows", rows, torch.int64, 2))
    if table.shape[1] % 2:
        raise ValueError(f"table must be (R, 2P), got {tuple(table.shape)}")
    if table.shape[0] >= 2**31:
        raise ValueError(f"table has {table.shape[0]} rows; the kernel takes fewer than 2**31")
    if rows.shape[0] != N:
        raise ValueError(f"rows must be (N={N}, K), got {tuple(rows.shape)}")
    _check_plan(N, rows.shape[1], table.shape[1] // 2, Qn)


def _launch(qids, qvals, table, rows, K, bias_id, bias_val) -> torch.Tensor:
    """One K1 launch on the tensors' card; ``rows`` None reads row n*K + k."""
    if table.data_ptr() % 8:
        raise ValueError("table must start on an 8-byte boundary (the kernel reads slot pairs)")
    lib = _build.load_library()
    N, Qn = qids.shape
    R, P = table.shape[0], table.shape[1] // 2
    plan = _launch_plan(N, K, P, Qn)
    out = torch.empty((N, K), dtype=torch.float32, device=qids.device)
    passes = _PASSES.get(qids.device)
    if passes is None:
        passes = _PASSES[qids.device] = _PassCount(qids.device)
    with torch.cuda.device(qids.device):
        stream = torch.cuda.current_stream(qids.device).cuda_stream
        err = lib.pecos_intersect_scores(
            qids.data_ptr(), qvals.data_ptr(), table.data_ptr(), R,
            None if rows is None else rows.data_ptr(), out.data_ptr(), passes.card.data_ptr(),
            K, P, Qn, plan.chunk, plan.slots.bit_length() - 1, plan.lanes, plan.per_block,
            plan.blocks_per_row, plan.grid, plan.shared_bytes,
            int(bias_id is not None), int(bias_id) if bias_id is not None else 0, float(bias_val), stream,
        )
    if err != 0:
        msg = lib.pecos_cuda_error_string(err).decode()
        raise RuntimeError(f"intersect_scores kernel launch failed: {msg} (cudaError {err})")
    intersect_scores.launches += 1
    passes.first += plan.grid
    passes.chunks += plan.grid * plan.chunks
    return out


def take_pass_counts(device) -> Optional[Tuple[int, int]]:
    """(query chunks whose candidate rows K1 read, query chunks it had),
    summed over the blocks of its launches on ``device`` since the last take,
    which this one zeroes; None where no launch has run there (the plain
    version counts nothing).  The card's count is copied to the host, which
    waits for the card: call it where the card has been waited for already.
    It is zeroed on the host (the reading is kept and subtracted next time),
    so a take adds no launch.  Every launch on the device counts, whoever
    made it: launches between two predicts (a RealtimeSession's, an HNSW
    search's, training's) count toward the next predict's reading."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    passes = _PASSES.get(device)
    if passes is None:
        return None
    now = int(passes.card.item())
    taken = passes.first + now - passes.taken, passes.chunks
    passes.taken, passes.first, passes.chunks = now, 0, 0
    return taken


def _require_cpu_or_cuda(qids):
    if qids.device.type not in ("cpu", "cuda"):
        raise ValueError(f"intersect_scores runs on cpu or cuda tensors, got {qids.device}")


def intersect_scores(
    qids: torch.Tensor,
    qvals: torch.Tensor,
    w_packed: torch.Tensor,
    bias_id: Optional[int] = None,
    bias_val: float = 0.0,
) -> torch.Tensor:
    """K1 over a gathered (N, K, 2P) block on the tensors' device: the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors (raises on
    anything the kernel does not take).  ``intersect_scores.launches`` counts
    the kernel's launches, by either entry point."""
    _require_cpu_or_cuda(qids)
    if qids.device.type == "cpu":
        return intersect_scores_reference(qids, qvals, w_packed, bias_id, bias_val)
    _check_cuda_args(qids, qvals, w_packed)
    N, K, P2 = w_packed.shape
    return _launch(qids, qvals, w_packed.view(N * K, P2), None, K, bias_id, bias_val)


intersect_scores.launches = 0


def intersect_scores_rows(
    qids: torch.Tensor,
    qvals: torch.Tensor,
    table: torch.Tensor,
    rows: torch.Tensor,
    bias_id: Optional[int] = None,
    bias_val: float = 0.0,
) -> torch.Tensor:
    """K1 by row id on the tensors' device: candidate (n, k) is row
    ``rows[n, k]`` of ``table`` (R, 2P), read in place; a row of -1 scores 0.
    The plain version for CPU tensors, the CUDA kernel for CUDA tensors
    (raises on anything the kernel does not take).  The kernel launch counts
    in ``intersect_scores.launches``."""
    _require_cpu_or_cuda(qids)
    if qids.device.type == "cpu":
        return intersect_scores_rows_reference(qids, qvals, table, rows, bias_id, bias_val)
    _check_rows_args(qids, qvals, table, rows)
    return _launch(qids, qvals, table, rows, rows.shape[1], bias_id, bias_val)
