"""The plain reference of XR-Transformer predict (concat-only) with a
DeepSeek-V3-family encoder (Moonlight-16B-A3B), in float32 PyTorch.

It imports nothing of the program, nor ``transformers``, ``tokenizers`` or
``jax``.  It is handed the benchmark's own arrays: the vocabulary's entries,
the encoder's tensors by name (the model's own, bfloat16 on the card: each
layer's are upcast to float32 when the layer runs and freed after it) and
widths from the configuration, and the ranker's arrays, which
``xrlinear_reference`` takes.

- Tokens: ``xtransformer_reference.tokens``: ``[CLS] w_1 .. w_{T-2} [SEP]``
  padded with ``[PAD]`` to T = ``truncate_length``, [CLS] and [SEP] standing
  for BOS and EOS.
- Encoder, after DeepSeek-V3's published modeling code as Moonlight's
  ``config.json`` sets it: the token embedding; per layer, h + MLA(RMSNorm(h))
  and h + FFN(RMSNorm(h)); the final RMSNorm; the mean over real tokens.
  MLA: q = h W_q split per head into (nope, rope); h W_kva split into the
  latent c and one rope key k_r shared by the heads; RMSNorm(c) (eps 1e-6)
  W_kvb split per head into (k nope, v); RoPE (theta ``rope_theta``) on the
  rope parts, their interleaved pairs regrouped into halves; softmax(q k^T /
  sqrt(nope + rope)) over keys at or before the query that are real tokens;
  the heads' outputs W_o.  FFN: the first ``first_k_dense_replace`` layers a
  SwiGLU (down(silu(gate x) * up x)); the others the shared experts' SwiGLU
  plus the routed experts: scores sigmoid(x W_r^T), the ``num_experts_per_tok``
  experts of largest score + ``e_score_correction_bias``, their unbiased
  scores normalised to sum 1 and times ``routed_scaling_factor`` as gate
  weights, each expert a SwiGLU of ``moe_intermediate_size`` (its gate and up
  projections stacked in ``experts.gate_up``, down in ``experts.down``).
  Departures from the published code: float32 throughout where it computes
  in bfloat16 (TF32 switched off); a loop over experts and over blocks of at
  most ``BLOCK_TEXTS`` texts; masked keys get -inf where the published code
  adds the dtype's lowest value (the same softmax: every query sees its BOS).
- Then each pooled output scaled to unit L2 norm and appended to the text's
  TF-IDF row, and ``xrlinear_reference``'s tree search over the D + H
  columns.

``calibrate`` runs the same layer functions over a calibration sample to
set each expert layer's correction bias (DeepSeek-V3's auxiliary-loss-free
rule) and to find the mean direction of the pooled outputs; ``Encoder.layer``
and ``local_error`` hold each of the program's layers to the reference's from
the same input.  The benchmark's model kind calls both at set-up.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as smat
import torch

from portbench.models import xrlinear_reference
from portbench.models.xtransformer_reference import tokens

BLOCK_TEXTS = 256
# the eps of kv_a_layernorm in the published modeling code (its RMSNorm's default)
LATENT_NORM_EPS = 1e-6


def model_config(cfg: Dict) -> Dict:
    """The encoder's configuration: the configuration's keys that
    ``encoder_keys`` names (the published ``config.json``'s)."""
    return {k: cfg[k] for k in cfg["encoder_keys"]}


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE on x (..., T, d): pairs (x_{2i}, x_{2i+1}) regrouped as halves,
    then each half-pair (a_i, b_i) rotated by position t's angle t theta_i."""
    d = x.shape[-1]
    a, b = x[..., 0::2], x[..., 1::2]
    c, s = cos[:, : d // 2], sin[:, : d // 2]
    return torch.cat([a * c - b * s, b * c + a * s], dim=-1)


def swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    g = x @ gate.T
    return (g * torch.sigmoid(g) * (x @ up.T)) @ down.T


class Encoder:
    """The forward over the model's tensors (``state``: name -> tensor, not
    copied), float32 on ``device``."""

    def __init__(self, state: Dict[str, torch.Tensor], mc: Dict, device: torch.device):
        self.state, self.device = state, device
        self.layers = int(mc["num_hidden_layers"])
        self.heads = int(mc["num_attention_heads"])
        self.nope, self.rope = int(mc["qk_nope_head_dim"]), int(mc["qk_rope_head_dim"])
        self.v_dim, self.rank = int(mc["v_head_dim"]), int(mc["kv_lora_rank"])
        self.eps = float(mc["rms_norm_eps"])
        self.dense_layers = int(mc["first_k_dense_replace"])
        self.top_k = int(mc["num_experts_per_tok"])
        self.scaling = float(mc["routed_scaling_factor"])
        self.normalize = bool(mc["norm_topk_prob"])
        self.theta = float(mc["rope_theta"])
        if mc.get("q_lora_rank") is not None or int(mc.get("n_group", 1)) != 1:
            raise ValueError("the reference writes out MLA without q LoRA and routing over one group")
        self.hidden = int(mc["hidden_size"])

    def weights(self, i: int) -> Dict[str, torch.Tensor]:
        """Layer i's tensors, upcast to float32 on the device (new tensors)."""
        p = f"layers.{i}."
        return {k[len(p) :]: v.to(device=self.device, dtype=torch.float32) for k, v in self.state.items()
                if k.startswith(p)}

    def embed(self, ids: np.ndarray) -> torch.Tensor:
        table = self.state["embed_tokens.weight"]
        return table[torch.as_tensor(ids, device=table.device)].to(device=self.device, dtype=torch.float32)

    def rope_tables(self, T: int) -> Tuple[torch.Tensor, torch.Tensor]:
        inv = self.theta ** (-torch.arange(0, self.rope, 2, device=self.device, dtype=torch.float64) / self.rope)
        ang = torch.arange(T, device=self.device, dtype=torch.float64)[:, None] * inv[None, :]
        ang = ang.float()
        return torch.cos(ang), torch.sin(ang)

    def attention(self, w: Dict[str, torch.Tensor], h: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        """h + MLA(RMSNorm(h)) for h (n, T, H), keep (n, T) bool."""
        n, T, H = h.shape
        x = rms_norm(h, w["input_layernorm.weight"], self.eps)
        a = "self_attn."
        q = (x @ w[a + "q_proj.weight"].T).view(n, T, self.heads, self.nope + self.rope).transpose(1, 2)
        ckv = x @ w[a + "kv_a_proj_with_mqa.weight"].T
        c, k_r = ckv[..., : self.rank], ckv[..., self.rank :]
        kv = rms_norm(c, w[a + "kv_a_layernorm.weight"], LATENT_NORM_EPS) @ w[a + "kv_b_proj.weight"].T
        kv = kv.view(n, T, self.heads, self.nope + self.v_dim).transpose(1, 2)
        cos, sin = self.rope_tables(T)
        q_r = rotate(q[..., self.nope :], cos, sin)
        k_r = rotate(k_r[:, None], cos, sin).expand(n, self.heads, T, self.rope)
        qq = torch.cat([q[..., : self.nope], q_r], dim=-1)
        kk = torch.cat([kv[..., : self.nope], k_r], dim=-1)
        v = kv[..., self.nope :]
        allowed = torch.ones((T, T), dtype=torch.bool, device=self.device).tril()[None, None] & keep[:, None, None, :]
        att = (qq @ kk.transpose(-1, -2)) / np.sqrt(self.nope + self.rope)
        att = torch.softmax(torch.where(allowed, att, float("-inf")), dim=-1)
        out = (att @ v).transpose(1, 2).reshape(n, T, self.heads * self.v_dim)
        return h + out @ w[a + "o_proj.weight"].T

    def ffn_input(self, w: Dict[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
        return rms_norm(h, w["post_attention_layernorm.weight"], self.eps)

    def scores(self, w: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        """The router's sigmoid scores (..., E)."""
        return torch.sigmoid(x @ w["mlp.gate.weight"].T)

    def route(self, scores: torch.Tensor, bias: torch.Tensor):
        """(experts, gate weights) (..., top_k) of the scores under a correction bias."""
        experts = torch.topk(scores + bias, self.top_k, dim=-1).indices
        gates = scores.gather(-1, experts)
        if self.normalize:
            gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
        return experts, gates * self.scaling

    def ffn(self, i: int, w: Dict[str, torch.Tensor], x: torch.Tensor, bias: Optional[torch.Tensor] = None):
        """FFN(x) of layer i for x (n, T, H); an expert layer routes under
        ``bias`` (default: the model's own correction bias)."""
        m = "mlp."
        if i < self.dense_layers:
            return swiglu(x, w[m + "gate_proj.weight"], w[m + "up_proj.weight"], w[m + "down_proj.weight"])
        s = m + "shared_experts."
        out = swiglu(x, w[s + "gate_proj.weight"], w[s + "up_proj.weight"], w[s + "down_proj.weight"])
        bias = w[m + "gate.e_score_correction_bias"] if bias is None else bias
        experts, gates = self.route(self.scores(w, x), bias)
        flat, e_flat, g_flat = x.reshape(-1, x.shape[-1]), experts.reshape(-1, self.top_k), gates.reshape(-1, self.top_k)
        routed = torch.zeros_like(flat)
        gu, down = w[m + "experts.gate_up"], w[m + "experts.down"]
        width = down.shape[2]
        for e in range(gu.shape[0]):
            tok, slot = torch.nonzero(e_flat == e, as_tuple=True)
            if len(tok):
                y = swiglu(flat[tok], gu[e, :width], gu[e, width:], down[e])
                routed.index_add_(0, tok, y * g_flat[tok, slot][:, None])
        return out + routed.view_as(x)

    def layer(self, i: int, w: Dict[str, torch.Tensor], h: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        """Layer i's output for its input h (n, T, H): h + MLA(RMSNorm(h)),
        then + FFN(RMSNorm(.)), routing under the model's correction bias."""
        h = self.attention(w, h, keep)
        return h + self.ffn(i, w, self.ffn_input(w, h))

    def pool(self, h: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        """The final RMSNorm, then the mean over real tokens (n, H)."""
        h = rms_norm(h, self.state["norm.weight"].to(device=self.device, dtype=torch.float32), self.eps)
        m = keep[..., None].float()
        return (h * m).sum(1) / m.sum(1).clamp(min=1.0)

    def pooled(self, ids: np.ndarray, mask: np.ndarray, layer_hook=None) -> torch.Tensor:
        """(n, H) float32 pooled outputs of token ids and masks (n, T), layer
        by layer over blocks of texts.  ``layer_hook(i, w, x, keep)``, where
        given, returns the correction bias layer i routes under, from its
        FFN inputs x (every text) before its FFN runs."""
        keep = torch.as_tensor(mask, device=self.device) > 0
        blocks = [slice(s, s + BLOCK_TEXTS) for s in range(0, len(ids), BLOCK_TEXTS)]
        h = torch.cat([self.embed(ids[b]) for b in blocks]) if blocks else torch.zeros((0, 1, self.hidden))
        for i in range(self.layers):
            w = self.weights(i)
            for b in blocks:
                h[b] = self.attention(w, h[b], keep[b])
            bias = None
            if layer_hook is not None and i >= self.dense_layers:
                bias = layer_hook(i, w, torch.cat([self.ffn_input(w, h[b]) for b in blocks]), keep)
            for b in blocks:
                h[b] = h[b] + self.ffn(i, w, self.ffn_input(w, h[b]), bias)
            del w
        return self.pool(h, keep)


def local_error(got: torch.Tensor, want: torch.Tensor, x: torch.Tensor, keep: torch.Tensor) -> float:
    """A layer's error against the reference from the same input: the
    median over real tokens (``keep``) of |got - want| / |want - x|, where x
    (n, T, H) is the layer's input, ``want`` the reference's output from x and
    ``got`` the output under test.  Relative to the layer's update, and a
    median: a token that a rounding re-routes moves its own error, not the
    reading."""
    err = (got - want)[keep].norm(dim=-1) / (want - x)[keep].norm(dim=-1)
    return float(err.median())


def balance_bias(scores: torch.Tensor, top_k: int, steps: int, gamma: float) -> torch.Tensor:
    """DeepSeek-V3's auxiliary-loss-free balance (arXiv:2412.19437 §2.1.2):
    from 0, ``steps`` times, bias_e -= gamma sign(load_e - mean load), the
    load of expert e being the tokens (rows of ``scores``) whose top-k of
    scores + bias hold e."""
    E = scores.shape[-1]
    bias = torch.zeros(E, dtype=torch.float32, device=scores.device)
    for _ in range(steps):
        top = torch.topk(scores + bias, top_k, dim=-1).indices
        load = torch.bincount(top.reshape(-1), minlength=E).float()
        bias -= gamma * torch.sign(load - load.mean())
    return bias


def calibrate(state: Dict[str, torch.Tensor], mc: Dict, vocab: Sequence[str], texts: Sequence[str], length: int,
              steps: int, gamma: float, device: torch.device):
    """The correction bias of each expert layer, set on its real tokens'
    scores over ``texts`` by ``balance_bias`` (each layer's after the layers
    before it are set), and the unit mean direction of the texts' unit
    pooled outputs.  Returns ({layer: bias (E,) float32}, direction (H,)
    float32, {layer: (busiest expert's load / mean load) before, after})."""
    enc = Encoder(state, mc, device)
    ids, mask = tokens(vocab, texts, length)
    biases, balance = {}, {}

    def hook(i, w, x, keep):
        s = enc.scores(w, x[keep])
        bias = balance_bias(s, enc.top_k, steps, gamma)
        ratio = []
        for b in (torch.zeros_like(bias), bias):
            load = torch.bincount(torch.topk(s + b, enc.top_k, dim=-1).indices.reshape(-1), minlength=len(bias))
            ratio.append(float(load.max()) / float(load.float().mean()))
        biases[i], balance[i] = bias, tuple(ratio)
        return bias

    pooled = enc.pooled(ids, mask, hook)
    unit = pooled / pooled.norm(dim=1, keepdim=True)
    mean = unit.mean(0)
    return biases, mean / mean.norm(), balance


class Reference:
    def __init__(self, model, cfg: Dict, device: torch.device):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.ranker = xrlinear_reference.build(model, cfg, device)
        self.encoder = Encoder(dict(model.encoder.state_dict()), model_config(cfg), device)
        self.vocab = model.vocab
        self.length = int(cfg["truncate_length"])
        self.children, self.depth = self.ranker.children, self.ranker.depth
        self._last = (None, None)  # (pool, its features): beam_search and path_values of one pool

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        """(n, H) float64 pooled outputs (computed in float32)."""
        if not len(texts):
            return np.zeros((0, self.encoder.hidden))
        ids, mask = tokens(self.vocab, texts, self.length)
        return self.encoder.pooled(ids, mask).double().cpu().numpy()

    def features(self, Q) -> smat.csr_matrix:
        """(n, D + H) float64: each TF-IDF row, then its text's embedding at unit L2 norm."""
        if self._last[0] is Q:
            return self._last[1]
        emb = self.embed(Q.texts)
        emb = emb / np.linalg.norm(emb, axis=1, keepdims=True)
        X = smat.hstack([Q.X.astype(np.float64), smat.csr_matrix(emb)], format="csr")
        self._last = (Q, X)
        return X

    def beam_search(self, Q, keep_beams: bool = False):
        return self.ranker.beam_search(self.features(Q), keep_beams=keep_beams)

    def path_values(self, Q, labels: np.ndarray) -> np.ndarray:
        return self.ranker.path_values(self.features(Q), labels)

    def real_tokens(self, texts: Sequence[str]) -> np.ndarray:
        """Each text's real tokens under the truncation (the work counters' count)."""
        return tokens(self.vocab, texts, self.length)[1].sum(1)


def build(model, cfg: Dict, device: torch.device) -> Reference:
    """The reference of ``model`` (``xtransformer_moe.Model``): its arrays alone."""
    return Reference(model, cfg, device)
