"""The sparse-expert layer's combine: each token's routed experts' rows,
weighted by their gates and summed in float32, plus the shared experts' row.

``expert_combine(pairs, gates, keep, shared)`` returns out (T, H) in
shared's dtype with, for token t of k experts,

    out[t] = (where(keep[t], sum_j gates[t, j] * pairs[t k + j].float(), 0).to(dtype)) + shared[t]

``pairs`` (T k, H), the pairs in token order (``ops.grouped_gemm_scatter``'s
output); ``gates`` (T, k) float32; ``keep`` (T,) bool; ``shared`` (T, H).  The
pair rows of a token whose ``keep`` is False are never read, so they may
hold anything.

It chooses by the device of its tensors: CPU tensors go to the plain version
(``expert_combine_reference``: a float32 batched matmul, ``where``, the cast
and the add, the unfused expert layer's ops), CUDA tensors to the CUDA kernel
(``csrc/expert_combine.cu``, bfloat16 only, one launch), or the call raises.
The kernel sums each token's terms in order, one fused multiply-add a term,
so on the card it may differ from the batched matmul's order in the float32
sum's last bit, and after the rounding to bfloat16 by a unit at most.  It is
bound by bytes.  ``expert_combine.launches`` counts its launches;
``KERNEL_NAME`` is its name in a profiler's trace.
"""

from __future__ import annotations

import torch

from . import _build

KERNEL_NAME = "expert_combine_kernel"
VECTOR = 8  # bf16 columns a thread of the kernel moves at once (kVec)


def expert_combine_reference(pairs: torch.Tensor, gates: torch.Tensor, keep: torch.Tensor,
                             shared: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch: the unfused expert layer's combine."""
    T, k = gates.shape
    routed = torch.bmm(gates[:, None, :], pairs.view(T, k, -1).float())[:, 0]
    return torch.where(keep[:, None], routed, 0.0).to(shared.dtype) + shared


def expert_combine(pairs: torch.Tensor, gates: torch.Tensor, keep: torch.Tensor, shared: torch.Tensor) -> torch.Tensor:
    """(T, H): the gate-weighted sum of each kept token's pair rows plus its
    shared row; the plain version on CPU tensors, the kernel on CUDA tensors
    (raises on anything it does not take)."""
    if gates.dim() != 2 or shared.dim() != 2 or gates.shape[0] != shared.shape[0]:
        raise ValueError(f"gates must be (T, k) and shared (T, H), got {tuple(gates.shape)} and {tuple(shared.shape)}")
    T, k = gates.shape
    H = shared.shape[1]
    if pairs.shape != (T * k, H) or keep.shape != (T,):
        raise ValueError(f"pairs must be ({T * k}, {H}) and keep ({T},), got {tuple(pairs.shape)} and "
                         f"{tuple(keep.shape)}")
    if gates.dtype != torch.float32 or keep.dtype != torch.bool or pairs.dtype != shared.dtype:
        raise ValueError(f"gates must be float32, keep bool and pairs of shared's dtype, got {gates.dtype}, "
                         f"{keep.dtype}, {pairs.dtype} and {shared.dtype}")
    tensors = (pairs, gates, keep, shared)
    if any(t.device != shared.device for t in tensors) or shared.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the tensors must share one cpu or cuda device, got {[str(t.device) for t in tensors]}")
    if shared.device.type == "cpu":
        return expert_combine_reference(pairs, gates, keep, shared)
    if shared.dtype != torch.bfloat16:
        raise ValueError(f"the kernel takes bfloat16 pairs and shared, got {shared.dtype}")
    if H % VECTOR or not all(t.is_contiguous() for t in tensors) or pairs.data_ptr() % 16 or shared.data_ptr() % 16:
        raise ValueError(f"the kernel takes contiguous tensors, H a multiple of {VECTOR} and pairs and shared on "
                         f"16-byte boundaries, got H {H}")
    out = torch.empty_like(shared)
    lib = _build.load_library()
    with torch.cuda.device(shared.device):
        stream = torch.cuda.current_stream(shared.device).cuda_stream
        err = lib.pecos_expert_combine(pairs.data_ptr(), gates.data_ptr(), keep.data_ptr(), shared.data_ptr(),
                                       out.data_ptr(), T, k, H, stream)
    if err != 0:
        msg = lib.pecos_cuda_error_string(err).decode()
        raise RuntimeError(f"expert_combine kernel launch failed: {msg} (cudaError {err})")
    expert_combine.launches += 1
    return out


expert_combine.launches = 0
