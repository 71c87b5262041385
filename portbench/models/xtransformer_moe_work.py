"""The operations and bytes that XR-Transformer predict (concat-only) with a
DeepSeek-V3-family encoder needs, counted from shapes and from the
reference's tokens and beam, never from the program's launches.

- The ranker's: ``xrlinear_work``'s count over the concatenated rows, as in
  ``xtransformer_work``.
- The grouped GEMMs of the expert layers (``moe``): a forward of up to
  ``encoder_batch`` texts has, in each expert layer, one (token, expert) pair
  for each of a real token's ``num_experts_per_tok`` experts (the program
  drops the pairs of padding tokens), and two launches: gate and up (N = 2 x
  the expert width, K = H), then down (N = H, K = the expert width).  A
  launch's operations are 2 pairs N K; its bytes are the rows it reads, the
  64 experts' weights and the rows it writes, each once, in bfloat16.  Its
  bound is the larger of operations at the bfloat16 peak and bytes at the
  HBM peak (``peaks_tensor.json``, by card name): operations, at these
  shapes.
- The encoder's (``encoder``): per token slot and layer, the latent
  attention's projections (q, the latent and its RoPE key, the latent up to
  keys and values, the output) and attention's scores and weighted sum over
  ``truncate_length`` slots; per slot, the dense FFN of the first layers,
  the shared experts and the router of the others; per real token, its
  routed experts.  Two operations a multiply-add.  Its bound per forward is
  those operations at the bfloat16 peak, or the weights read at the HBM peak
  if larger (the weights of a forward, ~31 GB, need ~6% of the operations'
  time).
- The whole predict (``mfu``): the encoder's bound, then the ranker's.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

# k1_levels and leaf_spread are the XR-Linear kind's: the concat ranker is XR-Linear
from portbench.models.xrlinear_work import k1_levels, leaf_spread, traced_work  # noqa: F401
from portbench.models.xtransformer_moe_reference import model_config

PEAKS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "peaks_tensor.json")
BYTES = 2  # bfloat16


def tensor_peaks(card: Optional[str] = None) -> Optional[Dict]:
    """The card's tensor-core peaks (``peaks_tensor.json``), by its name
    (default: the current CUDA card's), or None."""
    if card is None:
        import torch

        if not torch.cuda.is_available():
            return None
        card = torch.cuda.get_device_name(torch.cuda.current_device())
    with open(PEAKS) as f:
        return json.load(f).get(card)


def per_slot_macs(mc: Dict, slots: int) -> Dict[str, float]:
    """Multiply-adds a token slot computes in each kind of layer, apart from
    the routed experts: ``dense`` (a layer of the first
    ``first_k_dense_replace``) and ``sparse`` (an expert layer)."""
    H, nh = int(mc["hidden_size"]), int(mc["num_attention_heads"])
    nope, rope, v = int(mc["qk_nope_head_dim"]), int(mc["qk_rope_head_dim"]), int(mc["v_head_dim"])
    rank = int(mc["kv_lora_rank"])
    attn = H * nh * (nope + rope) + H * (rank + rope) + rank * nh * (nope + v) + nh * v * H
    attn += slots * nh * (nope + rope + v)
    dense = 3 * H * int(mc["intermediate_size"])
    shared = 3 * H * int(mc["n_shared_experts"]) * int(mc["moe_intermediate_size"])
    router = H * int(mc["n_routed_experts"])
    return {"dense": attn + dense, "sparse": attn + shared + router}


def layers(mc: Dict) -> Dict[str, int]:
    dense = int(mc["first_k_dense_replace"])
    return {"dense": dense, "sparse": int(mc["num_hidden_layers"]) - dense}


def pair_macs(mc: Dict) -> float:
    """Multiply-adds of one (token, expert) pair: the expert's SwiGLU."""
    return 3.0 * int(mc["hidden_size"]) * int(mc["moe_intermediate_size"])


def launches(mc: Dict, pairs: int):
    """The two grouped GEMMs of one expert layer's forward over ``pairs``
    pairs: (operations, bytes) each."""
    H, I, E = int(mc["hidden_size"]), int(mc["moe_intermediate_size"]), int(mc["n_routed_experts"])
    out = []
    for N, K in ((2 * I, H), (H, I)):
        out.append((2.0 * pairs * N * K, BYTES * (pairs * K + E * N * K + pairs * N)))
    return out


def forward_work(mc: Dict, texts: int, slots: int, tokens: int, tpeaks: Dict) -> Dict[str, float]:
    """One forward of ``texts`` texts of ``slots`` slots holding ``tokens``
    real tokens: the encoder's and the grouped GEMMs' operations, bytes and
    bounds, and the grouped GEMMs' launches."""
    flops, bw = float(tpeaks["bf16_flop_per_s"]), float(tpeaks["hbm_bytes_per_s"])
    per_slot, n = per_slot_macs(mc, slots), layers(mc)
    pairs = tokens * int(mc["num_experts_per_tok"])
    moe = {"ops": 0.0, "bytes": 0, "seconds": 0.0, "calls": 0}
    for ops, nbytes in launches(mc, pairs):
        moe["ops"] += n["sparse"] * ops
        moe["bytes"] += n["sparse"] * nbytes
        moe["seconds"] += n["sparse"] * max(ops / flops, nbytes / bw)
        moe["calls"] += n["sparse"]
    enc_ops = 2.0 * texts * slots * sum(n[k] * per_slot[k] for k in n) + moe["ops"]
    weights = BYTES * weight_count(mc)
    enc = {"ops": enc_ops, "bytes": weights, "seconds": max(enc_ops / flops, weights / bw), "pairs": pairs}
    return {"moe": moe, "encoder": enc}


def weight_count(mc: Dict) -> int:
    """Weights the encoder reads in a forward: every layer's, the embedding
    rows aside (a forward gathers a few)."""
    H, E, I = int(mc["hidden_size"]), int(mc["n_routed_experts"]), int(mc["moe_intermediate_size"])
    per_slot, n = per_slot_macs(mc, 0), layers(mc)
    return int(n["dense"] * per_slot["dense"] + n["sparse"] * (per_slot["sparse"] + 3 * E * H * I))


def traced(ref, model, traced_queries, cfg: Dict, peaks: Dict, tpeaks: Optional[Dict] = None) -> Dict[str, object]:
    """The work of the traced batches (pool slices, one a batch): the
    ranker's as ``xtransformer_work`` counts it; with the card's tensor
    peaks, the encoder's (``encoder``), the grouped GEMMs' (``moe``) and the
    whole predict's.  ``tpeaks`` defaults to the current card's."""
    from portbench.models import xtransformer

    mc = model_config(cfg)
    Q = xtransformer.stack(traced_queries)
    beams = ref.beam_search(Q, keep_beams=True)["beams"]
    children = [ref.children[d].cpu().numpy() for d in range(ref.depth)]
    real = [(v != 0).sum(axis=1) for v in model.vals]
    H = model.D - model.text_features
    batches, s = [], 0
    for q in traced_queries:
        n = q.shape[0]
        batches.append((np.diff(q.X.indptr) + H, [b[s : s + n] for b in beams]))
        s += n
    work = traced_work(batches, children, real, k1_levels(model.D, model.sizes), int(cfg["only_topk"]), peaks)
    tpeaks = tpeaks or tensor_peaks()
    if tpeaks is None:
        return work
    tokens = ref.real_tokens(Q.texts)
    slots, block = int(cfg["truncate_length"]), int(cfg["encoder_batch"])
    moe = {"ops": 0.0, "bytes": 0, "seconds": 0.0, "calls": 0, "pairs": 0, "by": "operations",
           "experts": int(mc["n_routed_experts"])}
    enc = {"ops": 0.0, "bytes": 0, "seconds": 0.0, "texts": len(tokens), "tokens": int(tokens.sum())}
    # a call's texts go through the encoder encoder_batch at a time: within
    # each traced batch, as the call's blocks fall where the batch size is a
    # multiple of encoder_batch or a call is one batch (the reader checks
    # the launches against the trace)
    forwards, s = [], 0
    for q in traced_queries:
        n = q.shape[0]
        forwards += [tokens[a : min(a + block, s + n)] for a in range(s, s + n, block)]
        s += n
    for t in forwards:
        one = forward_work(mc, len(t), slots, int(t.sum()), tpeaks)
        for key in ("ops", "bytes", "seconds", "calls"):
            moe[key] += one["moe"][key]
        for key in ("ops", "bytes", "seconds"):
            enc[key] += one["encoder"][key]
        moe["pairs"] += one["encoder"]["pairs"]
    ranker = work["predict"]
    work["ranker"], work["moe"], work["encoder"] = ranker, moe, enc
    work["predict"] = {"seconds": enc["seconds"] + ranker["seconds"], "ops": enc["ops"] + ranker["ops"],
                       "bytes": enc["bytes"] + ranker["bytes"], "by": "encoder operations, ranker " + ranker["by"]}
    return work
