"""Device and seeding helpers (counterpart of ``pecos_tpu/utils/jax_util.py``)."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """``torch.device`` for ``device``; raises if a CUDA device is asked for and
    there is none, so no model silently runs on the CPU instead."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} was requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
    return dev


def make_generator(seed: int, device: DeviceLike = "cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    return gen


# float64 elements of one prefix-sum block in segment_sum (512 MB)
_SEGMENT_SUM_BLOCK = 1 << 26
# elements of a row that one scan covers in _prefix_sums
_SCAN_CHUNK = 1024


def _prefix_sums(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the rows of a 2-D tensor, in a fixed order:
    each chunk of _SCAN_CHUNK elements is scanned, then the chunks' totals,
    and each chunk gets the sum of the chunks before it.  Every scan is short
    and along a contiguous axis, so a long row is not one thread's loop."""
    R, n = x.shape
    m = max(1, -(-n // _SCAN_CHUNK))
    chunks = torch.nn.functional.pad(x, (0, m * _SCAN_CHUNK - n)).view(R, m, _SCAN_CHUNK).cumsum(2)
    totals = chunks[:, :, -1]
    chunks = chunks + (totals.cumsum(1) - totals)[:, :, None]
    return chunks.view(R, m * _SCAN_CHUNK)[:, :n]


def run_sums(src: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Sums of runs of rows, in an order that does not change from run to run:
    ``out[b, j] = src[b, starts[b, j]:ends[b, j]].sum(0)`` for src (B, n, F)
    and starts, ends (B, m) int64 -> (B, m, F) in ``src``'s dtype, each run's
    sum the difference of two float64 prefix sums.  The prefix sums run along
    the last, contiguous axis of a transposed copy (a scan along the row axis
    would be one thread per column), on column blocks of at most
    ``_SEGMENT_SUM_BLOCK`` float64 elements."""
    B, n, F = src.shape
    m = starts.shape[1]
    out = torch.empty((B, m, F), dtype=src.dtype, device=src.device)
    step = max(1, _SEGMENT_SUM_BLOCK // max(1, B * n))
    for c in range(0, F, step):
        part = src[:, :, c : c + step]
        w = part.shape[2]
        part = part.double().transpose(1, 2).reshape(B * w, n)
        part = torch.nn.functional.pad(_prefix_sums(part).view(B, w, n), (1, 0))  # (B, w, n + 1), a zero before each run
        at = lambda pos: part.gather(2, pos[:, None, :].expand(B, w, m))
        out[:, :, c : c + w] = (at(ends) - at(starts)).transpose(1, 2).to(src.dtype)
    return out


def segment_sum(index: torch.Tensor, src: torch.Tensor, n_out: int) -> torch.Tensor:
    """``zeros((n_out, F)).index_add_(0, index, src)`` for index (n,) and src
    (n, F), or the same for each of B problems at once (index (B, n), src
    (B, n, F) -> (B, n_out, F)), with a result that does not depend on the
    order of the additions: the rows are sorted by target (stable) and each
    target's run summed by :func:`run_sums`.

    On a GPU ``index_add_`` and ``scatter_add_`` add floats with atomics in
    an order that changes from run to run, so one seed could give two
    different clusterings; this sum repeats bit for bit."""
    batched = index.dim() == 2
    index, src = (index, src) if batched else (index[None], src[None])
    B, n = index.shape
    order = torch.argsort(index, dim=1, stable=True)
    bins = index + torch.arange(B, device=index.device)[:, None] * n_out
    ends = torch.bincount(bins.reshape(-1), minlength=B * n_out).reshape(B, n_out).cumsum(1)
    starts = torch.cat([ends.new_zeros((B, 1)), ends[:, :-1]], dim=1)
    out = run_sums(src.gather(1, order[:, :, None].expand(B, n, src.shape[2])), starts, ends)
    return out if batched else out[0]
