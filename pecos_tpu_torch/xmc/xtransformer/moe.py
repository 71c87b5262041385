"""The sparse-expert layer of DeepSeek-V3-style encoders (Moonlight-16B-A3B).

A router scores every token against ``E`` experts; each token goes to its
``top_k`` experts and comes back as the gate-weighted sum of their outputs.
As the published code computes it (DeepSeek-V3, arXiv:2412.19437 §2.1.2, and
its ``modeling_deepseek.py``):

- scores = sigmoid(x W_r^T), in float32;
- the experts chosen are the top-k of scores + ``e_score_correction_bias``
  (``noaux_tc`` with one group: the bias steers the choice only);
- their gate weights are the unbiased scores of the chosen experts,
  normalised to sum 1 (``norm_topk_prob``) and times
  ``routed_scaling_factor``;
- expert e is a SwiGLU, down(silu(gate(x)) * up(x)), in the model's dtype;
  the weighted sum over a token's experts is taken in float32 and cast back.

How the port runs it, with no Python loop over experts and nothing that
waits for the card: the (token, expert) pairs are sorted by expert
(``torch.sort``, stable), the group offsets found on the card
(``torch.searchsorted``), and three hand-written kernels do the rest, so
that of the pairs' rows only the gathered tokens, act and the down
projection's output cross device memory:

1. ``ops.grouped_gemm_swiglu``: the experts' gate and up projections (fused,
   2 x the expert width) as one grouped GEMM over all experts of the pairs'
   token rows (``x[order // k]``, a gather), ``silu(gate) * up`` taken in its
   epilogue: act (pairs, width), rounded as ``F.silu(h[:, :I]) * h[:, I:]``
   rounds the bfloat16 h, which is never stored.  Bound by its operations.
2. ``ops.grouped_gemm_scatter``: the down projections, each pair's row
   stored in its token slot (row ``order[r]`` = t k + j of a (T k, H)
   buffer), the token order the combine reads.  Bound by its operations.
3. ``ops.expert_combine``: for each token the gate-weighted sum of its k
   rows in float32, cast to the model's dtype, plus the shared experts'
   output, in one pass.  Bound by its bytes.

The pairs of padding tokens (``keep`` False) are sorted past the last
expert, so the grouped GEMMs neither compute nor store them and the combine
reads none of their slots; those tokens' outputs are the shared experts'
alone: in an encoder that reads padding nowhere (right padding under a
causal mask, pooling over real tokens) this changes no output that is
read.  On the CPU the layer runs the unfused ops the kernels replace, with
the same roundings: ``ops.grouped_gemm``'s plain version (``torch.matmul``
a group) for each projection, SiLU and the product, ``index_put``, then the
combine's plain version (a float32 ``bmm``, ``where``, the cast and the add).

Span ``pecos.moe`` covers each layer's enqueue; counter ``pecos.moe.layers``
counts the layers run and ``pecos.moe.fused`` those whose three kernels
launched (0 on the CPU).  Two counts are kept on the
card, never read inside a forward: the pairs computed and the busiest
expert's pairs, each summed over layer forwards.  ``take_counts(device)``
moves them into counters ``pecos.moe.pairs`` and ``pecos.moe.max_load``;
call it after a fetch that has waited for the card.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from pecos_tpu_torch.ops.expert_combine import expert_combine
from pecos_tpu_torch.ops.grouped_gemm import grouped_gemm, grouped_gemm_scatter, grouped_gemm_swiglu
from pecos_tpu_torch.utils import profile_util

# per device: int64 (2,) on it, [pairs computed, busiest expert's pairs]
_COUNTS: Dict[torch.device, torch.Tensor] = {}


def route(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, top_k: int, scaling: float,
          normalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(experts (T, top_k) int64, gate weights (T, top_k) float32) of tokens
    x (T, H) under router ``weight`` (E, H) and correction ``bias`` (E,)."""
    scores = F.linear(x.float(), weight.float()).sigmoid()
    experts = torch.topk(scores + bias, top_k, dim=-1, sorted=False).indices
    gates = scores.gather(1, experts)
    if normalize:
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
    return experts, gates * scaling


def _add_counts(offsets: torch.Tensor) -> None:
    dev = offsets.device
    acc = _COUNTS.get(dev)
    if acc is None:
        acc = _COUNTS[dev] = torch.zeros(2, dtype=torch.int64, device=dev)
    load = offsets[1:] - offsets[:-1]
    acc += torch.stack([offsets[-1], load.max()])


def take_counts(device) -> Optional[Tuple[int, int]]:
    """(pairs computed, busiest expert's pairs), summed over the expert
    layers run on ``device`` since the last take, which zeroes them; None
    where none has run.  Reads the card: call it where the card has been
    waited for.  Adds them to counters ``pecos.moe.pairs`` and
    ``pecos.moe.max_load``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    acc = _COUNTS.get(device)
    if acc is None:
        return None
    pairs, max_load = (int(v) for v in acc.tolist())
    acc.zero_()
    profile_util.count("pecos.moe.pairs", pairs)
    profile_util.count("pecos.moe.max_load", max_load)
    return pairs, max_load


class Router(torch.nn.Module):
    """The router's weight (E, H) and its correction bias (E,), float32 (a
    buffer, as published: it is set outside gradient training)."""

    def __init__(self, hidden: int, n_experts: int, dtype=None, device=None):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.empty((n_experts, hidden), dtype=dtype, device=device))
        self.register_buffer("e_score_correction_bias", torch.zeros(n_experts, dtype=torch.float32, device=device))


class Experts(torch.nn.Module):
    """The routed experts' weights, stacked: ``gate_up`` (E, 2I, H), expert
    e's gate projection in rows :I and its up projection in rows I:;
    ``down`` (E, H, I)."""

    def __init__(self, hidden: int, width: int, n_experts: int, dtype=None, device=None):
        super().__init__()
        self.width = width
        self.gate_up = torch.nn.Parameter(torch.empty((n_experts, 2 * width, hidden), dtype=dtype, device=device))
        self.down = torch.nn.Parameter(torch.empty((n_experts, hidden, width), dtype=dtype, device=device))


class SwiGLU(torch.nn.Module):
    """down(silu(gate(x)) * up(x)), no biases: a dense FFN or the shared experts."""

    def __init__(self, hidden: int, width: int, dtype=None, device=None):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, device=device)
        self.gate_proj = torch.nn.Linear(hidden, width, **kw)
        self.up_proj = torch.nn.Linear(hidden, width, **kw)
        self.down_proj = torch.nn.Linear(width, hidden, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class ExpertLayer(torch.nn.Module):
    """The routed experts plus the shared experts (one SwiGLU of
    ``n_shared`` x the expert width), as the FFN of a decoder layer."""

    def __init__(self, hidden: int, width: int, n_experts: int, top_k: int, n_shared: int, scaling: float,
                 normalize: bool = True, dtype=None, device=None):
        super().__init__()
        self.n_experts, self.top_k, self.scaling, self.normalize = n_experts, top_k, scaling, normalize
        self.gate = Router(hidden, n_experts, dtype=dtype, device=device)
        self.experts = Experts(hidden, width, n_experts, dtype=dtype, device=device)
        self.shared_experts = SwiGLU(hidden, n_shared * width, dtype=dtype, device=device)

    def routed(self, x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        """The layer's output for tokens x (T, H): the routed experts'
        weighted sum, zero for a token whose ``keep`` (T,) is False (no
        expert computes it), plus the shared experts' output; the combine
        adds the two."""
        T = x.shape[0]
        k, E, I = self.top_k, self.n_experts, self.experts.width
        experts, gates = route(x, self.gate.weight, self.gate.e_score_correction_bias, k, self.scaling, self.normalize)
        flat = torch.where(keep[:, None].expand(T, k).reshape(-1), experts.reshape(-1), E)
        sorted_experts, order = torch.sort(flat, stable=True)
        offsets = torch.searchsorted(sorted_experts, torch.arange(E + 1, device=x.device))
        _add_counts(offsets)
        gathered, shared = x[order // k], self.shared_experts(x)
        if x.device.type == "cuda":
            act = grouped_gemm_swiglu(gathered, self.experts.gate_up, offsets)
            out = expert_combine(grouped_gemm_scatter(act, self.experts.down, offsets, order), gates, keep, shared)
            profile_util.count("pecos.moe.fused")
            return out
        h = grouped_gemm(gathered, self.experts.gate_up, offsets)
        y = grouped_gemm(F.silu(h[:, :I]) * h[:, I:], self.experts.down, offsets)
        pairs = torch.empty_like(y)
        pairs[order] = y
        return expert_combine(pairs, gates, keep, shared)

    def forward(self, x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        """x (..., H); ``keep`` (...) bool, False for the tokens no expert computes."""
        with profile_util.span("pecos.moe"):
            profile_util.count("pecos.moe.layers")
            shape = x.shape
            return self.routed(x.reshape(-1, shape[-1]), keep.reshape(-1)).view(shape)
