"""A DeepSeek-V3-family decoder used as a text encoder: Moonlight-16B-A3B's
architecture (``model_type`` ``deepseek_v3``), with latent attention (MLA)
and sparse experts, in the port's own modules.

The configuration is ``transformers``' ``DeepseekV3Config`` with the
published keys; the modules below are the port's, so every ``transformers``
version runs the same code.  The forward follows the published modeling
code (DeepSeek-V2/V3, arXiv:2405.04434 and 2412.19437; Moonlight's
``config.json``):

- the token embedding; then per layer ``x + MLA(RMSNorm(x))`` and
  ``x + FFN(RMSNorm(x))``; the final RMSNorm;
- MLA: ``q_proj`` to (nope ‖ rope) per head (no q LoRA);
  ``kv_a_proj_with_mqa`` to the latent (``kv_lora_rank``) and one RoPE key
  shared by the heads; ``kv_a_layernorm`` (eps 1e-6, the published code's
  default, not ``rms_norm_eps``); ``kv_b_proj`` to (k nope ‖ v) per head;
  RoPE on the rope dims, in the published pair order (the interleaved
  pairs regrouped into halves, then rotate-half); softmax scale
  (nope + rope)^-1/2; a causal mask and the key-padding mask; ``o_proj``;
- the FFN: a SwiGLU of ``intermediate_size`` in the first
  ``first_k_dense_replace`` layers, then ``moe.ExpertLayer`` (routed experts
  plus the shared experts);
- RMSNorm in float32, its output cast back and scaled by its weight.

The model has no pooler: its text embedding is the mean of the last hidden
states over real tokens (the port's rule for families without one,
``network.pooled_embedding``), in float32.  Weights, activations and products are in the model's dtype
(bfloat16 on the card); RMSNorm and the router's scores are float32, as
published.  Texts are right-padded, so under
the causal mask no real token attends to a pad, and the expert layers drop
the pad tokens' (token, expert) pairs (``moe``): no output that is read
changes.

The family is predict-only: the grouped GEMM kernel has no backward.  A
random model is drawn by ``from_seed`` on a given device in a given dtype.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .moe import ExpertLayer, SwiGLU

# kv_a_layernorm's eps in the published modeling code (its RMSNorm's default)
LATENT_NORM_EPS = 1e-6


@dataclasses.dataclass
class EncoderOutput:
    last_hidden_state: torch.Tensor  # (B, T, H) in the model's dtype; no pooler


def setting(config, name: str, default=None):
    """A configuration value, also where a ``transformers`` version keeps the
    RoPE settings in ``rope_parameters``."""
    value = getattr(config, name, None)
    if value is None:
        value = (getattr(config, "rope_parameters", None) or {}).get(name, default)
    return value


def check_config(config) -> None:
    """Raise on settings the port does not implement."""
    unsupported = {
        "q_lora_rank": (getattr(config, "q_lora_rank", None), None),
        "n_group": (getattr(config, "n_group", 1), 1),
        "topk_group": (getattr(config, "topk_group", 1), 1),
        "scoring_func": (getattr(config, "scoring_func", "sigmoid"), "sigmoid"),
        "hidden_act": (getattr(config, "hidden_act", "silu"), "silu"),
        "attention_bias": (getattr(config, "attention_bias", False), False),
        "moe_layer_freq": (getattr(config, "moe_layer_freq", 1), 1),
        "rope_interleave": (getattr(config, "rope_interleave", True), True),
    }
    bad = {k: v for k, (v, want) in unsupported.items() if v != want}
    scaling = setting(config, "rope_scaling")
    if scaling and scaling.get("rope_type", scaling.get("type", "default")) != "default":
        bad["rope_scaling"] = scaling
    if bad:
        raise NotImplementedError(f"deepseek_v3 settings the port does not implement: {bad}")


class RMSNorm(torch.nn.Module):
    def __init__(self, width: int, eps: float, dtype=None, device=None):
        super().__init__()
        self.eps = eps
        self.weight = torch.nn.Parameter(torch.empty(width, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v = x.float()
        v = v * torch.rsqrt(v.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight * v.to(x.dtype)


def rope_tables(T: int, dim: int, theta: float, device, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin (T, dim) of positions 0..T-1, frequencies theta^(-2i/dim),
    each repeated for the two halves; computed in float32, cast to dtype."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.int64, device=device).float() / dim))
    freqs = torch.arange(T, device=device, dtype=torch.float32)[:, None] * inv[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., T, d): the interleaved pairs (x0, x1), (x2, x3), ... regrouped
    as halves (x0, x2, .. | x1, x3, ..), then x cos + rotate_half(x) sin."""
    *lead, T, d = x.shape
    x = x.reshape(*lead, T, d // 2, 2).transpose(-1, -2).reshape(*lead, T, d)
    half = torch.cat([-x[..., d // 2 :], x[..., : d // 2]], dim=-1)
    return x * cos + half * sin


class Attention(torch.nn.Module):
    """Multi-head latent attention without q LoRA."""

    def __init__(self, config, dtype=None, device=None):
        super().__init__()
        H = config.hidden_size
        self.heads = config.num_attention_heads
        self.nope, self.rope = config.qk_nope_head_dim, config.qk_rope_head_dim
        self.v_dim, self.rank = config.v_head_dim, config.kv_lora_rank
        self.scaling = (self.nope + self.rope) ** -0.5
        kw = dict(bias=False, dtype=dtype, device=device)
        self.q_proj = torch.nn.Linear(H, self.heads * (self.nope + self.rope), **kw)
        self.kv_a_proj_with_mqa = torch.nn.Linear(H, self.rank + self.rope, **kw)
        # the published code builds this norm with its default eps, 1e-6, not rms_norm_eps
        self.kv_a_layernorm = RMSNorm(self.rank, LATENT_NORM_EPS, dtype=dtype, device=device)
        self.kv_b_proj = torch.nn.Linear(self.rank, self.heads * (self.nope + self.v_dim), **kw)
        self.o_proj = torch.nn.Linear(self.heads * self.v_dim, H, **kw)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        q = self.q_proj(x).view(B, T, self.heads, -1).transpose(1, 2)
        q_nope, q_rot = q.split([self.nope, self.rope], dim=-1)
        latent, k_rot = self.kv_a_proj_with_mqa(x).split([self.rank, self.rope], dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(latent)).view(B, T, self.heads, -1).transpose(1, 2)
        k_nope, v = kv.split([self.nope, self.v_dim], dim=-1)
        q_rot = apply_rope(q_rot, cos, sin)
        k_rot = apply_rope(k_rot.view(B, 1, T, self.rope), cos, sin).expand(B, self.heads, T, self.rope)
        q = torch.cat([q_nope, q_rot], dim=-1)
        k = torch.cat([k_nope, k_rot], dim=-1)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=self.scaling)
        return self.o_proj(out.transpose(1, 2).reshape(B, T, self.heads * self.v_dim))


class DecoderLayer(torch.nn.Module):
    def __init__(self, config, index: int, dtype=None, device=None):
        super().__init__()
        H, eps = config.hidden_size, config.rms_norm_eps
        self.input_layernorm = RMSNorm(H, eps, dtype=dtype, device=device)
        self.self_attn = Attention(config, dtype=dtype, device=device)
        self.post_attention_layernorm = RMSNorm(H, eps, dtype=dtype, device=device)
        self.sparse = index >= config.first_k_dense_replace
        if self.sparse:
            self.mlp = ExpertLayer(
                H, config.moe_intermediate_size, config.n_routed_experts, config.num_experts_per_tok,
                config.n_shared_experts, float(config.routed_scaling_factor), bool(config.norm_topk_prob),
                dtype=dtype, device=device,
            )
        else:
            self.mlp = SwiGLU(H, config.intermediate_size, dtype=dtype, device=device)

    def forward(self, h, cos, sin, mask, keep):
        h = h + self.self_attn(self.input_layernorm(h), cos, sin, mask)
        x = self.post_attention_layernorm(h)
        return h + (self.mlp(x, keep) if self.sparse else self.mlp(x))


def tensor_seed(seed: int, name: str) -> int:
    """The 63-bit seed of parameter ``name``'s draw."""
    state = np.random.SeedSequence([seed % 2**64, zlib.crc32(name.encode())]).generate_state(1, np.uint64)[0]
    return int(state) >> 1


class DeepseekV3Encoder(torch.nn.Module):
    """The encoder: ``forward(input_ids, attention_mask)`` gives an
    ``EncoderOutput``; ``config`` is a ``DeepseekV3Config``."""

    def __init__(self, config, dtype=None, device=None):
        super().__init__()
        check_config(config)
        self.config = config
        self.embed_tokens = torch.nn.Embedding(config.vocab_size, config.hidden_size, dtype=dtype, device=device)
        self.layers = torch.nn.ModuleList(
            DecoderLayer(config, i, dtype=dtype, device=device) for i in range(config.num_hidden_layers)
        )
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, dtype=dtype, device=device)
        self.rope_theta = float(setting(config, "rope_theta", 10000.0))

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None) -> EncoderOutput:
        B, T = input_ids.shape
        dev = input_ids.device
        keep = torch.ones((B, T), dtype=torch.bool, device=dev) if attention_mask is None else attention_mask > 0
        h = self.embed_tokens(input_ids)
        cos, sin = rope_tables(T, self.config.qk_rope_head_dim, self.rope_theta, dev, h.dtype)
        causal = torch.ones((T, T), dtype=torch.bool, device=dev).tril()
        mask = causal[None, None] & keep[:, None, None, :]
        for layer in self.layers:
            h = layer(h, cos, sin, mask, keep)
        return EncoderOutput(last_hidden_state=self.norm(h))

    @classmethod
    def from_seed(cls, config, seed: int, device="cpu", dtype=torch.float32) -> "DeepseekV3Encoder":
        """A random model on ``device`` in ``dtype``: each parameter drawn in
        float32 from its own seed (``tensor_seed(seed, name)``), N(0,
        initializer_range^2) (the published initializer; norms 1), on the
        device, then rounded to ``dtype``; the routers' correction biases 0.
        One seed gives one model on every device of a type."""
        device = torch.device(device)
        with torch.device("meta"):
            model = cls(config, dtype=dtype)
        model = model.to_empty(device=device)
        std = float(getattr(config, "initializer_range", 0.02))
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("norm.weight"):
                    p.fill_(1.0)
                    continue
                gen = torch.Generator(device=device)
                gen.manual_seed(tensor_seed(seed, name))
                p.copy_(torch.randn(p.shape, generator=gen, device=device, dtype=torch.float32).mul_(std))
            for name, b in model.named_buffers():
                b.zero_()
        return model.eval()
