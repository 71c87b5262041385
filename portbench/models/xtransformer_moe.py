"""XR-Transformer predict with a sparse-expert encoder: the model a
configuration file with ``"model": "xtransformer_moe"`` names.

The program is the same as ``xtransformer.py``'s: ``XTransformer.predict(texts,
X_feat=..., ens_method="concat-only")``, its encoder here the port's
``deepseek_v3`` family (Moonlight-16B-A3B: latent attention, 64 routed
experts a layer) in the configuration's ``dtype``.  The queries, the
vocabulary, the texts and the ranker's tree and sparse weights are the
XR-Transformer kind's (``xtransformer.py``, ``xrlinear.py``), imported, not
copied.  What differs (``portbench/README.md`` has the contract):

- ``Model``: the program's encoder module is built with no storage and
  given the benchmark's own weights (``draw_encoder``): each tensor drawn on
  the card from a seed of its own, in float32, rounded to the
  configuration's dtype, and loaded with a strict ``load_state_dict``; the
  program uses it in place: a second copy would not fit beside the ranker.
  Then, through the reference's own layer functions
  (``xtransformer_moe_reference.calibrate``) over a seeded calibration
  sample of texts that is not the pool (``calibration``: its size, its
  ``text_words`` law, the ``steps`` and ``gamma`` of the rule), each expert
  layer's correction bias is set by DeepSeek-V3's auxiliary-loss-free rule,
  and the mean direction u of the sample's unit pooled outputs is found.
  Last, the encoder check (``encoder_check``): over the first ``texts``
  texts of that sample, each of the program's layers, run by the program's
  own forward, is held to the reference's layer from the same input
  (``xtransformer_moe_reference.local_error``: the median over real tokens
  of the error over the layer's update), and set-up fails where a layer
  reads above ``limit``.  The comparison after the window cannot see the
  encoder's precision (random routers re-route tokens under any rounding,
  and the scores compared carry it through 27 layers), so the check sees it
  here, layer by layer.  The ranker's H dense weights a node
  are drawn N(0, weight_std^2) as in ``xtransformer.Model`` and centred
  against u (w - (w . u) u): a random encoder's outputs share a direction,
  which would otherwise add one offset to every node's score and bunch the
  beams.
- ``Program``: ``XTransformer(TransformerMatcher(model.encoder, ...),
  XLinearModel)``; ``wire`` is the ranker's query wire.
- the plain reference is ``xtransformer_moe_reference.py`` beside this file
  (float32); the operations and bytes of the work are counted in
  ``xtransformer_moe_work.py``.
"""

from __future__ import annotations

import os
import sys
import tempfile
import zlib
from typing import Dict, List

import numpy as np
import torch

from portbench.models import xrlinear, xtransformer
from portbench.models.xtransformer import (  # noqa: F401  (the kind's queries are XR-Transformer's)
    TextQueries, arrays, make_texts, match_level, queries, row_sizes, stack, sub_seed, vocabulary, word_counts,
)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Model(xrlinear.Model):
    """The ranker's tree and weights over D + H columns, the encoder (on the
    device), the vocabulary and tokenizer, and the matcher's head, from the
    seed; ``balance`` holds each expert layer's busiest expert over the mean
    load on the calibration sample, before and after its bias was set, and
    ``direction`` the unit mean direction the dense weights are centred
    against, and ``layer_errors`` the encoder check's reading of each
    layer."""

    def __init__(self, cfg: Dict, seed: int, device: torch.device):
        from pecos_tpu_torch.xmc.xtransformer import network

        from portbench.models import xtransformer_moe_reference as reference

        mc = reference.model_config(cfg)
        H = int(mc["hidden_size"])
        # the encoder first: a program without this family fails here, at once
        self.encoder = draw_encoder(cfg["encoder_type"], mc, sub_seed(seed, "weights", 3), device, DTYPES[cfg["dtype"]])
        super().__init__(cfg, seed, device)
        self.vocab = vocab = vocabulary(int(mc["vocab_size"]), sub_seed(seed, "weights", 2))
        cal, length = cfg["calibration"], int(cfg["truncate_length"])
        counts = word_counts(int(cal["texts"]), cal["text_words"], sub_seed(seed, "weights", 5))
        texts = make_texts(vocab, counts, sub_seed(seed, "weights", 6))
        state = dict(self.encoder.state_dict())
        biases, direction, self.balance = reference.calibrate(
            state, mc, vocab, texts, length, int(cal["steps"]), float(cal["gamma"]), device)
        with torch.no_grad():
            for i, bias in biases.items():
                state[f"layers.{i}.mlp.gate.e_score_correction_bias"].copy_(bias)
        del biases
        print("calibration: busiest expert over the mean load, before and after each layer's bias: "
              + ", ".join(f"{i} {a:.3f}/{b:.3f}" for i, (a, b) in sorted(self.balance.items())), file=sys.stderr)
        check = cfg["encoder_check"]
        ids, mask = reference.tokens(vocab, texts[: int(check["texts"])], length)
        self.layer_errors = layer_errors(self.encoder, reference.Encoder(state, mc, device), ids, mask, device)
        del state
        worst = int(np.argmax(self.layer_errors))
        line = (f"encoder check: each layer against the reference's from the same input, the median over "
                f"{int(mask.sum())} real tokens of |error| / |update|: largest {self.layer_errors[worst]!r} at layer "
                f"{worst} (limit {float(check['limit'])!r}); per layer "
                + " ".join(f"{e:.3e}" for e in self.layer_errors))
        print(line, file=sys.stderr)
        if self.layer_errors[worst] > float(check["limit"]):
            raise RuntimeError(line)

        gen = torch.Generator(device=device)
        gen.manual_seed(sub_seed(seed, "weights", 1))
        dense = float(cfg["weight_std"]) * torch.randn((sum(self.sizes), H), generator=gen, device=device)
        self.direction = u = direction.to(device=device, dtype=torch.float32)
        dense = (dense - (dense @ u)[:, None] * u[None, :]).cpu().numpy()
        self._append_dense(dense, H)
        del dense
        fd, path = tempfile.mkstemp(prefix="portbench-vocab-", suffix=".txt")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                f.write("\n".join(self.vocab) + "\n")
            self.tokenizer = network.wordpiece_tokenizer(path)
        finally:
            os.remove(path)
        n_match = self.sizes[match_level(self.sizes, int(cfg["max_match_clusters"]))]
        self.head = network.XMCHead.random(n_match, H, seed=sub_seed(seed, "weights", 4))

    def _append_dense(self, dense: np.ndarray, H: int) -> None:
        """Every node's H dense weights on columns D..D+H-1, before the bias,
        which moves to column D + H (``xtransformer.Model``'s layout)."""
        bounds = np.cumsum([0] + self.sizes)
        D = self.D
        cols = np.arange(D, D + H, dtype=np.int32)
        for d, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
            n, P = self.ids[d].shape
            ids = np.empty((n, P + H), np.int32)
            vals = np.empty((n, P + H), np.float32)
            ids[:, : P - 1], ids[:, P - 1 : P - 1 + H], ids[:, -1] = self.ids[d][:, :-1], cols, D + H
            vals[:, : P - 1], vals[:, P - 1 : P - 1 + H], vals[:, -1] = self.vals[d][:, :-1], dense[a:b], self.vals[d][:, -1]
            self.ids[d], self.vals[d] = ids, vals
        self.text_features = D
        self.D = D + H


def tensor_seed(seed: int, name: str) -> int:
    """The 63-bit seed of tensor ``name``'s draw."""
    state = np.random.SeedSequence([seed % 2**64, zlib.crc32(name.encode())]).generate_state(1, np.uint64)[0]
    return int(state) >> 1


def draw_encoder(encoder_type: str, mc: Dict, seed: int, device: torch.device, dtype: torch.dtype):
    """The program's encoder module of ``encoder_type`` and widths ``mc``,
    built with no storage, then given the benchmark's weights by a strict
    ``load_state_dict``: every tensor of its state by name, RMSNorm weights
    (``*norm.weight``) 1, the routers' correction biases 0, the others drawn
    N(0, initializer_range^2) in float32 on ``device`` from a seed of their
    own (``tensor_seed(seed, name)``) and rounded to the module's dtype for
    that tensor."""
    from pecos_tpu_torch.xmc.xtransformer import network

    config_cls, model_cls, _ = network.resolve_encoder(encoder_type)
    module = model_cls(config_cls(**mc), dtype=dtype, device="meta")
    std = float(mc["initializer_range"])
    state = {}
    for name, t in module.state_dict().items():
        if name.endswith("norm.weight"):
            state[name] = torch.ones(t.shape, dtype=t.dtype, device=device)
        elif name.endswith("e_score_correction_bias"):
            state[name] = torch.zeros(t.shape, dtype=t.dtype, device=device)
        else:
            gen = torch.Generator(device=device)
            gen.manual_seed(tensor_seed(seed, name))
            state[name] = (std * torch.randn(t.shape, generator=gen, device=device, dtype=torch.float32)).to(t.dtype)
    module.load_state_dict(state, strict=True, assign=True)
    return module.eval()


def layer_errors(encoder, ref, ids: np.ndarray, mask: np.ndarray, device: torch.device) -> List[float]:
    """Each layer of the program's ``encoder``, as its own forward over token
    ``ids`` and ``mask`` (n, T) runs it, against the reference's layer
    (``ref``, a ``xtransformer_moe_reference.Encoder`` over the same weights)
    from the same input, upcast to float32: ``local_error`` a layer, in
    order.  TF32 is off while the reference runs."""
    from portbench.models import xtransformer_moe_reference as reference

    keep = torch.as_tensor(mask, device=device) > 0
    errors: List[float] = []

    def hook(layer, args, out):
        i = len(errors)
        x = args[0].float()
        errors.append(reference.local_error(out.float(), ref.layer(i, ref.weights(i), x, keep), x, keep))

    handles = [layer.register_forward_hook(hook) for layer in encoder.layers]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            encoder(input_ids=torch.as_tensor(ids, device=device), attention_mask=torch.as_tensor(mask, device=device))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        for h in handles:
            h.remove()
    return errors


class Program:
    """``XTransformer.predict`` (concat-only) over the model's own encoder
    (not copied), tokenizer, head and ranker, on ``device``; as
    ``xtransformer.Program`` otherwise."""

    def __init__(self, model: Model, device: torch.device, wire: str = "float32"):
        import inspect

        from pecos_tpu_torch.xmc.xtransformer import TransformerMatcher, XTransformer

        cfg = model.cfg
        default = inspect.signature(TransformerMatcher._embed).parameters["batch_size"].default
        if int(cfg["encoder_batch"]) != default:
            raise ValueError(f"the configuration's encoder_batch {cfg['encoder_batch']} is not the "
                             f"{default} texts a forward that XTransformer.predict runs")
        ranker = xrlinear.Program(model, device, wire=wire)
        level = match_level(model.sizes, int(cfg["max_match_clusters"]))
        matcher = TransformerMatcher(
            model.encoder, model.tokenizer, model.head,
            C=model.cluster_matrix(level) if level else None,
            pred_params=dict(truncate_length=int(cfg["truncate_length"]), only_topk=int(cfg["only_topk"]),
                             post_processor=cfg["post_processor"], ensemble_method="concat-only"),
            device=device,
        )
        self.xtf = XTransformer(matcher, ranker.xlm)
        self.kw = dict(ranker.kw, ens_method="concat-only")

    def predict(self, Q: TextQueries):
        return self.xtf.predict(Q.texts, X_feat=Q.X, **self.kw)
