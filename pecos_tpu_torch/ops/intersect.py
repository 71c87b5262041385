"""K1: sparse-query x sparse-weight id-intersection scoring.

The hot loop of XR-Linear beam-search predict: every plabel layer scores its
beam's candidate labels with it.  It replaces the Pallas TPU kernel
``pecos_tpu/ops/intersect.py:intersect_scores_pallas``; the CUDA source and a
note on what bounds it on the card are in ``csrc/intersect.cu``.

``intersect_scores`` chooses by the device of its tensors: CPU tensors go to
the plain PyTorch version ``intersect_scores_reference``; CUDA tensors go to the
CUDA kernel, or the call raises.  There is no other switch.

Numerical contract (that of ``pecos_tpu/xmc/inference.py:_intersect_scores``):
the matched-value sum is exact (CSR ids are unique per row, so each weight slot
matches at most one query nonzero); only the order of the final P-sum differs
between the kernel and the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

# query nonzeros compared per step of the plain version: an unchunked
# (N, K, P, Qn) compare block is ~2.7e9 elements at the predict path's shape
_REF_QUERY_CHUNK = 64


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


def _check_cuda_args(qids, qvals, w_packed):
    dev = qids.device
    for name, t, dtype, ndim in (
        ("qids", qids, torch.int32, 2),
        ("qvals", qvals, torch.float32, 2),
        ("w_packed", w_packed, torch.int32, 3),
    ):
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
    if w_packed.shape[0] != N or w_packed.shape[2] % 2:
        raise ValueError(f"w_packed must be (N={N}, K, 2P), got {tuple(w_packed.shape)}")
    K = w_packed.shape[1]
    if N > 2**31 - 1 or -(-K // 32) > 65535:
        raise ValueError(f"grid too large for N={N}, K={K}")


def intersect_scores(
    qids: torch.Tensor,
    qvals: torch.Tensor,
    w_packed: torch.Tensor,
    bias_id: Optional[int] = None,
    bias_val: float = 0.0,
) -> torch.Tensor:
    """K1 on the tensors' device: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (raises on anything the kernel does not take).
    ``intersect_scores.launches`` counts the kernel's launches."""
    if qids.device.type == "cpu":
        return intersect_scores_reference(qids, qvals, w_packed, bias_id, bias_val)
    if qids.device.type != "cuda":
        raise ValueError(f"intersect_scores runs on cpu or cuda tensors, got {qids.device}")
    _check_cuda_args(qids, qvals, w_packed)
    lib = _build.load_library()
    N, Qn = qids.shape
    K, P = w_packed.shape[1], w_packed.shape[2] // 2
    out = torch.empty((N, K), dtype=torch.float32, device=qids.device)
    with torch.cuda.device(qids.device):
        stream = torch.cuda.current_stream(qids.device).cuda_stream
        err = lib.pecos_intersect_scores(
            qids.data_ptr(), qvals.data_ptr(), w_packed.data_ptr(), out.data_ptr(),
            N, K, P, Qn, int(bias_id is not None),
            int(bias_id) if bias_id is not None else 0, float(bias_val), stream,
        )
    if err != 0:
        msg = lib.pecos_cuda_error_string(err).decode()
        raise RuntimeError(f"intersect_scores kernel launch failed: {msg} (cudaError {err})")
    intersect_scores.launches += 1
    return out


intersect_scores.launches = 0
