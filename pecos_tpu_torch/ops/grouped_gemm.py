"""The grouped GEMM of the sparse-expert layer: each group of rows of A times
its own expert's weights.

``grouped_gemm(a, w, offsets)`` returns out (M, N) with
``out[r] = a[r] @ w[e].T`` for the rows r of group e, ``offsets[e] <= r <
offsets[e + 1]``.  ``a`` is (M, K), ``w`` (E, N, K) (an ``nn.Linear``'s
(out, in) layout per expert), ``offsets`` (E + 1,) int64 on the tensors'
device, ascending from 0.  Rows at and past ``offsets[E]`` are left as the
output's allocation has them (the plain version zeroes them): the expert
layer sorts the pairs of padding tokens there.

It chooses by the device of its tensors: CPU tensors go to the plain
version, a loop of ``torch.matmul`` over the groups, which reads the offsets
on the host; CUDA tensors go to the CUDA kernel (``csrc/grouped_gemm.cu``,
bfloat16 only, one launch over every group, offsets read on the card), or
the call raises.  ``grouped_gemm.launches`` counts the kernel's launches;
``KERNEL_NAME`` is the kernel's name in a profiler's trace.  The port never
calls a library's grouped GEMM.
"""

from __future__ import annotations

import torch

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


def _check(a: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> None:
    if a.dim() != 2 or w.dim() != 3 or w.shape[2] != a.shape[1]:
        raise ValueError(f"a must be (M, K) and w (E, N, K), got {tuple(a.shape)} and {tuple(w.shape)}")
    if offsets.shape != (w.shape[0] + 1,) or offsets.dtype != torch.int64:
        raise ValueError(f"offsets must be ({w.shape[0] + 1},) int64, got {tuple(offsets.shape)} {offsets.dtype}")
    if a.device != w.device or offsets.device != a.device:
        raise ValueError(f"a, w and offsets must share a device: {a.device}, {w.device}, {offsets.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"grouped_gemm runs on cpu or cuda tensors, got {a.device}")


def _check_cuda(a: torch.Tensor, w: torch.Tensor) -> None:
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"the kernel takes bfloat16 a and w, got {a.dtype} and {w.dtype}")
    if not (a.is_contiguous() and w.is_contiguous()):
        raise ValueError("a and w must be contiguous")
    if w.shape[1] % TILE_COLS or w.shape[2] % STAGE_DEPTH:
        raise ValueError(f"the kernel takes N a multiple of {TILE_COLS} and K of {STAGE_DEPTH}, "
                         f"got N {w.shape[1]}, K {w.shape[2]}")
    if a.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("a and w must start on a 16-byte boundary (TMA)")
    if -(-a.shape[0] // TILE_ROWS) + w.shape[0] > 65535 or w.shape[0] * w.shape[1] >= 2**31:
        raise ValueError(f"too many rows for one launch: M {a.shape[0]}, E {w.shape[0]}, N {w.shape[1]}")


def grouped_gemm(a: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """(M, N): each group's rows of ``a`` times its expert's ``w[e]``
    transposed; the plain version on CPU tensors, the kernel on CUDA tensors
    (raises on anything it does not take)."""
    _check(a, w, offsets)
    if a.device.type == "cpu":
        return grouped_gemm_reference(a, w, offsets)
    _check_cuda(a, w)
    offsets = offsets.contiguous()
    M, K = a.shape
    E, N, _ = w.shape
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    lib = _build.load_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.pecos_grouped_gemm(a.data_ptr(), w.data_ptr(), offsets.data_ptr(), out.data_ptr(), M, E, N, K, stream)
    if err < 0:
        raise RuntimeError(f"grouped_gemm: the TMA descriptors could not be made (code {err}; "
                           f"-1: no cuTensorMapEncodeTiled in libcuda.so.1, else -1000 - CUresult)")
    if err != 0:
        msg = lib.pecos_cuda_error_string(err).decode()
        raise RuntimeError(f"grouped_gemm kernel launch failed: {msg} (cudaError {err})")
    grouped_gemm.launches += 1
    return out


grouped_gemm.launches = 0
