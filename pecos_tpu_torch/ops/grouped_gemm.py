"""The grouped GEMMs of the sparse-expert layer: each group of rows of A times
its own expert's weights.

``grouped_gemm(a, w, offsets)`` returns out (M, N) with
``out[r] = a[r] @ w[e].T`` for the rows r of group e, ``offsets[e] <= r <
offsets[e + 1]``.  ``a`` is (M, K), ``w`` (E, N, K) (an ``nn.Linear``'s
(out, in) layout per expert), ``offsets`` (E + 1,) int64 on the tensors'
device, ascending from 0.  Rows at and past ``offsets[E]`` are left as the
output's allocation has them (the plain version zeroes them): the expert
layer sorts the pairs of padding tokens there.

The expert layer's two projections take the same kernel with another
epilogue, so that the pairs' rows stay out of device memory between kernels:

- ``grouped_gemm_swiglu(a, w, offsets)``: the gate and up projections
  (``w`` (E, 2I, K), gate rows first) and ``silu(gate) * up`` in the
  epilogue, act (M, I), with the roundings of PyTorch's
  ``F.silu(h[:, :I]) * h[:, I:]`` over the bfloat16 product h, which never
  reaches device memory.
- ``grouped_gemm_scatter(a, w, offsets, dest)``: the down projection, row r
  of the product stored in row ``dest[r]`` of out, the pair's token slot.

Each chooses by the device of its tensors: CPU tensors go to the plain
version (``*_reference``: ``torch.matmul`` a group, which reads the offsets
on the host, then the same elementwise ops or index_put as the unfused
code), CUDA tensors go to the CUDA kernel (``csrc/grouped_gemm.cu``,
bfloat16 only, one launch over every group, offsets read on the card), or
the call raises.  ``grouped_gemm.launches`` counts the kernel's launches in
every mode; ``KERNEL_NAME`` is in every mode's name in a profiler's trace.
What bounds a launch is its operations, 2 M N K (at most ~1 GB of operands
against ~2 TFLOP at the expert layer's shapes); the epilogues change only
the bytes written.  The port never calls a library's grouped GEMM.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

KERNEL_NAME = "grouped_gemm_kernel"
# the kernel's geometry (kBM, kBN, kBK in csrc/grouped_gemm.cu): rows and
# columns of a tile, depth of a stage; N and K have to be multiples of a
# tile's columns and of a stage's depth
TILE_ROWS, TILE_COLS, STAGE_DEPTH = 128, 128, 64


def grouped_gemm_reference(a: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch: one ``torch.matmul`` a non-empty group, in a's dtype
    (float32 accumulation on the card and in CPU bfloat16 products); rows at
    and past ``offsets[E]`` are zero."""
    out = torch.zeros((a.shape[0], w.shape[1]), dtype=a.dtype, device=a.device)
    bounds = offsets.tolist()
    for e in range(w.shape[0]):
        lo, hi = bounds[e], bounds[e + 1]
        if hi > lo:
            out[lo:hi] = torch.matmul(a[lo:hi], w[e].T)
    return out


def grouped_gemm_swiglu_reference(a: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch: the grouped GEMM, then SiLU of the gate half times the
    up half, each in a's dtype; rows at and past ``offsets[E]`` are zero."""
    h = grouped_gemm_reference(a, w, offsets)
    width = w.shape[1] // 2
    return F.silu(h[:, :width]) * h[:, width:]


def grouped_gemm_scatter_reference(a: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
                                   dest: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch: the grouped GEMM, then its rows below ``offsets[E]``
    put in rows ``dest`` of zeros (M, N)."""
    y = grouped_gemm_reference(a, w, offsets)
    out = torch.zeros_like(y)
    n = int(offsets[-1])
    out[dest[:n]] = y[:n]
    return out


def _check(a: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> None:
    if a.dim() != 2 or w.dim() != 3 or w.shape[2] != a.shape[1]:
        raise ValueError(f"a must be (M, K) and w (E, N, K), got {tuple(a.shape)} and {tuple(w.shape)}")
    if offsets.shape != (w.shape[0] + 1,) or offsets.dtype != torch.int64:
        raise ValueError(f"offsets must be ({w.shape[0] + 1},) int64, got {tuple(offsets.shape)} {offsets.dtype}")
    if a.device != w.device or offsets.device != a.device:
        raise ValueError(f"a, w and offsets must share a device: {a.device}, {w.device}, {offsets.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"grouped_gemm runs on cpu or cuda tensors, got {a.device}")


def _check_cuda(a: torch.Tensor, w: torch.Tensor, M: int) -> None:
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"the kernel takes bfloat16 a and w, got {a.dtype} and {w.dtype}")
    if not (a.is_contiguous() and w.is_contiguous()):
        raise ValueError("a and w must be contiguous")
    if w.shape[1] % TILE_COLS or w.shape[2] % STAGE_DEPTH:
        raise ValueError(f"the kernel takes N a multiple of {TILE_COLS} and K of {STAGE_DEPTH}, "
                         f"got N {w.shape[1]}, K {w.shape[2]}")
    if a.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("a and w must start on a 16-byte boundary (TMA)")
    if -(-M // TILE_ROWS) + w.shape[0] > 65535 or w.shape[0] * w.shape[1] >= 2**31:
        raise ValueError(f"too many rows for one launch: M {M}, E {w.shape[0]}, N {w.shape[1]}")


def _raise_on(err: int, what: str) -> None:
    if err < 0:
        raise RuntimeError(f"{what}: the TMA descriptors could not be made (code {err}; "
                           f"-1: no cuTensorMapEncodeTiled in libcuda.so.1, else -1000 - CUresult)")
    if err != 0:
        msg = _build.load_library().pecos_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} (cudaError {err})")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch(entry: str, a: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor, out: torch.Tensor,
            *extra: torch.Tensor) -> torch.Tensor:
    """Launch mode ``entry`` of the kernel (``pecos_<entry>`` in the
    library; ``extra`` are its tensors between the offsets and out) on a's
    current stream, and count it in ``grouped_gemm.launches``."""
    _check_cuda(a, w, a.shape[0])
    offsets = offsets.contiguous()
    M, K = a.shape
    E, N, _ = w.shape
    lib = _build.load_library()
    with torch.cuda.device(a.device):
        err = getattr(lib, "pecos_" + entry)(a.data_ptr(), w.data_ptr(), offsets.data_ptr(),
                                             *(t.data_ptr() for t in extra), out.data_ptr(), M, E, N, K,
                                             _stream(a.device))
    _raise_on(err, entry)
    grouped_gemm.launches += 1
    return out


def grouped_gemm(a: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """(M, N): each group's rows of ``a`` times its expert's ``w[e]``
    transposed; the plain version on CPU tensors, the kernel on CUDA tensors
    (raises on anything it does not take)."""
    _check(a, w, offsets)
    if a.device.type == "cpu":
        return grouped_gemm_reference(a, w, offsets)
    out = torch.empty((a.shape[0], w.shape[1]), dtype=a.dtype, device=a.device)
    return _launch("grouped_gemm", a, w, offsets, out)


def grouped_gemm_swiglu(a: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """(M, I): ``silu(gate) * up`` of each group's rows of ``a`` times its
    expert's ``w[e]`` (2I, K) transposed, gate rows :I, up rows I:.  Rows at
    and past ``offsets[E]`` are not written on the card."""
    _check(a, w, offsets)
    if w.shape[1] % 2:
        raise ValueError(f"w must hold gate and up rows, 2I of them, got {w.shape[1]}")
    if a.device.type == "cpu":
        return grouped_gemm_swiglu_reference(a, w, offsets)
    out = torch.empty((a.shape[0], w.shape[1] // 2), dtype=a.dtype, device=a.device)
    return _launch("grouped_gemm_swiglu", a, w, offsets, out)


def grouped_gemm_scatter(a: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor, dest: torch.Tensor) -> torch.Tensor:
    """(M, N): row r of each group's rows of ``a`` times its expert's
    ``w[e]`` transposed, for r < ``offsets[E]``, stored in row ``dest[r]``
    ((M,) int64, distinct rows).  Rows that no such r names are left as
    allocated (zero in the plain version)."""
    _check(a, w, offsets)
    if dest.shape != (a.shape[0],) or dest.dtype != torch.int64 or dest.device != a.device:
        raise ValueError(f"dest must be ({a.shape[0]},) int64 on {a.device}, got {tuple(dest.shape)} {dest.dtype} "
                         f"on {dest.device}")
    if a.device.type == "cpu":
        return grouped_gemm_scatter_reference(a, w, offsets, dest)
    out = torch.empty((a.shape[0], w.shape[1]), dtype=a.dtype, device=a.device)
    return _launch("grouped_gemm_scatter", a, w, offsets, out, dest.contiguous())


# launches of the kernel in any mode
grouped_gemm.launches = 0
