"""The plain reference of XR-Transformer predict (concat-only), in float64 PyTorch.

It imports nothing of the program, nor ``transformers`` or ``tokenizers``.
It is handed the benchmark's own arrays: the vocabulary's entries, the
encoder's state dict (its tensors taken by name) and widths from the
configuration, and the ranker's arrays, which ``xrlinear_reference`` takes.

- Tokens: each text lower-cased and split on whitespace, each word looked
  up in the vocabulary, then ``[CLS] w_1 .. w_{T-2} [SEP]``, padded with
  ``[PAD]`` to T = ``truncate_length``.  This is WordPiece's answer exactly
  where every word is a whole vocabulary entry, as the benchmark's texts are;
  a word outside the vocabulary raises.
- Encoder: BERT's forward (Devlin et al. 2019, as ``bert-base-cased``'s
  ``config.json`` sets it): word, position (0..T-1) and token-type (all 0)
  embeddings, LayerNorm; per layer, Q/K/V projections, softmax(Q K^T /
  sqrt(head size)) with padded keys masked out, the output projection, the
  residual, LayerNorm, the feed-forward with erf-GELU, the residual,
  LayerNorm; then the pooler tanh(W h[CLS] + b).  Departures from the
  published description: dropout is left out (predict runs in eval mode),
  and masked keys get -inf where the published code adds a large negative
  number (the same softmax for any row with a real key, and [CLS] always is
  one).  Float64 throughout on the reference's device, with TF32 switched
  off, in blocks of at most ``BLOCK_TEXTS`` texts.
- Then each pooled output scaled to unit L2 norm and appended to the text's
  TF-IDF row, and ``xrlinear_reference``'s tree search over the D + H
  columns: ``beam_search``, ``path_values``, ``children`` and ``depth`` are
  that contract's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import scipy.sparse as smat
import torch

from portbench.models import xrlinear_reference

BLOCK_TEXTS = 512


def tokens(vocab: Sequence[str], texts: Sequence[str], length: int):
    """(ids, mask), each (len(texts), length) int64."""
    index = {w: i for i, w in enumerate(vocab)}
    cls, sep, pad = index["[CLS]"], index["[SEP]"], index["[PAD]"]
    ids = np.full((len(texts), length), pad, np.int64)
    mask = np.zeros((len(texts), length), np.int64)
    for r, text in enumerate(texts):
        row = [cls] + [index[w] for w in text.lower().split()[: length - 2]] + [sep]
        ids[r, : len(row)] = row
        mask[r, : len(row)] = 1
    return ids, mask


class Encoder:
    """BERT's forward over a state dict's tensors, float64 on ``device``."""

    def __init__(self, state: Dict[str, torch.Tensor], model_config: Dict, device: torch.device):
        self.w = {k: v.detach().to(device=device, dtype=torch.float64) for k, v in state.items()
                  if v.is_floating_point()}
        self.layers = int(model_config["num_hidden_layers"])
        self.heads = int(model_config["num_attention_heads"])
        self.eps = float(model_config["layer_norm_eps"])
        if model_config.get("hidden_act", "gelu") != "gelu":
            raise ValueError("the reference writes out BERT's erf-GELU only")
        self.device = device

    def _dense(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return x @ self.w[name + ".weight"].T + self.w[name + ".bias"]

    def _norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps) * self.w[name + ".weight"] + self.w[name + ".bias"]

    def pooled(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """(n, H) float64 pooled outputs of token ids and masks (n, T)."""
        ids = torch.as_tensor(ids, device=self.device)
        keep = torch.as_tensor(mask, device=self.device) > 0
        n, T = ids.shape
        e = "embeddings."
        h = (self.w[e + "word_embeddings.weight"][ids] + self.w[e + "position_embeddings.weight"][:T]
             + self.w[e + "token_type_embeddings.weight"][0])
        h = self._norm(h, e + "LayerNorm")
        H = h.shape[-1]
        hd = H // self.heads
        masked = torch.where(keep, 0.0, float("-inf")).to(torch.float64)[:, None, None, :]
        for i in range(self.layers):
            p = f"encoder.layer.{i}."

            def split(x):
                return x.view(n, T, self.heads, hd).transpose(1, 2)

            q, k, v = (split(self._dense(h, p + "attention.self." + m)) for m in ("query", "key", "value"))
            att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd) + masked, dim=-1)
            ctx = (att @ v).transpose(1, 2).reshape(n, T, H)
            h = self._norm(self._dense(ctx, p + "attention.output.dense") + h, p + "attention.output.LayerNorm")
            f = self._dense(h, p + "intermediate.dense")
            f = 0.5 * f * (1.0 + torch.erf(f / math.sqrt(2.0)))
            h = self._norm(self._dense(f, p + "output.dense") + h, p + "output.LayerNorm")
        return torch.tanh(self._dense(h[:, 0], "pooler.dense"))


class Reference:
    def __init__(self, model, cfg: Dict, device: torch.device):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.ranker = xrlinear_reference.build(model, cfg, device)
        self.encoder = Encoder(model.encoder.state_dict(), cfg["model_config"], device)
        self.vocab = model.vocab
        self.length = int(cfg["truncate_length"])
        self.children, self.depth = self.ranker.children, self.ranker.depth
        self._last = (None, None)  # (pool, its features): beam_search and path_values of one pool

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        """(n, H) float64 pooled outputs."""
        out: List[np.ndarray] = []
        for s in range(0, len(texts), BLOCK_TEXTS):
            ids, mask = tokens(self.vocab, texts[s : s + BLOCK_TEXTS], self.length)
            out.append(self.encoder.pooled(ids, mask).cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0, self.encoder.w["pooler.dense.bias"].shape[0]))

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


def build(model, cfg: Dict, device: torch.device) -> Reference:
    """The reference of ``model`` (``xtransformer.Model``): its arrays alone."""
    return Reference(model, cfg, device)
