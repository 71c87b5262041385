"""XR-Transformer predict: the model a configuration file with ``"model": "xtransformer"`` names.

Its predict, ``XTransformer.predict(texts, X_feat=..., ens_method="concat-only")``
in the port, tokenizes each text, encodes it with a transformer encoder (the
pooled output), appends the L2-normalized embedding to the text's TF-IDF row
as H dense columns, and ranks the concatenation with ``XLinearModel.predict``
(the concat ranker).  The parts the harness drives (``portbench/README.md``
has the contract):

- ``Model``: made from the seed.  The ranker is ``xrlinear.Model``'s tree and
  sparse weights over the D TF-IDF features, and on every node H dense
  weights on columns D..D+H-1, N(0, weight_std^2), before the bias, which
  moves to feature D + H; ``D`` is the ranker's D + H.  The encoder is
  ``network.random_encoder(encoder_type, model_config, ...)``: the family's
  own initializer (BERT: N(0, initializer_range^2), LayerNorm 1 and 0, zero
  biases) drawn on the host, kept there (the reference reads its state dict).
  The vocabulary (``vocabulary``) holds the five specials, then distinct
  lowercase ASCII words, and the tokenizer is the port's
  ``network.wordpiece_tokenizer`` over it, built from a vocabulary file under
  ``TMPDIR`` that is deleted once read.  The matcher's head is
  ``XMCHead.random`` over the deepest level of at most
  ``max_match_clusters`` nodes; concat-only predict does not score it.
- ``Program``: ``XTransformer(TransformerMatcher(...), XLinearModel)``
  through their public constructors; its ``predict`` is
  ``XTransformer.predict``.  ``wire`` is the ranker's query wire, as in
  ``xrlinear.Program``.  The encoder runs ``encoder_batch`` texts a forward,
  which has to be ``TransformerMatcher._embed``'s default, since
  ``XTransformer.predict`` takes no batch size.
- the queries (``TextQueries``): texts, as Python strings of words drawn
  uniformly from the vocabulary's words, beside their TF-IDF rows
  (``traffic.query_pool``) row for row.  A text's length in words follows the
  mix's ``text_words``: ``{"law": "lognormal", "median": m, "sigma": s,
  "min": a, "max": b}`` (or any law of ``traffic.quantile_lengths``, with its
  ``mean``), fixed quantiles in a seeded order.  ``row_sizes`` is a query's
  TF-IDF nonzeros plus its words.
- the plain reference is ``xtransformer_reference.py`` beside this file; the
  operations and bytes of the work are counted in ``xtransformer_work.py``.
"""

from __future__ import annotations

import copy
import math
import os
import tempfile
from typing import Dict, List, Sequence

import numpy as np
import scipy.sparse as smat
import torch

from portbench import traffic
from portbench.models import xrlinear

SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
# characters a vocabulary word may have, and its length range
WORD_CHARS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
WORD_LEN = (2, 12)


def sub_seed(seed: int, tag: str, k: int) -> int:
    """A 63-bit seed for the k-th draw of a ``traffic`` purpose."""
    state = np.random.SeedSequence([traffic.sub_seed(seed, tag), k]).generate_state(1, np.uint64)[0]
    return int(state) >> 1


def vocabulary(size: int, seed: int) -> List[str]:
    """``size`` entries: ``SPECIALS``, then distinct lowercase ASCII words of
    ``WORD_LEN`` letters, from the seed."""
    rng = np.random.default_rng(seed)
    words: Dict[str, None] = {}
    n = size - len(SPECIALS)
    while len(words) < n:
        m = 2 * (n - len(words)) + 64
        lens = rng.integers(WORD_LEN[0], WORD_LEN[1] + 1, m)
        chars = WORD_CHARS[rng.integers(0, len(WORD_CHARS), (m, WORD_LEN[1]))]
        for row, k in zip(chars, lens):
            words.setdefault(row[:k].tobytes().decode("ascii"))
            if len(words) == n:
                break
    return list(SPECIALS) + list(words)


def word_counts(n: int, spec: Dict, seed: int) -> np.ndarray:
    """n texts' lengths in words: fixed quantiles of ``spec`` in a seeded order."""
    spec = dict(spec)
    if "median" in spec:  # a lognormal's mean from its median
        spec["mean"] = float(spec.pop("median")) * math.exp(float(spec["sigma"]) ** 2 / 2)
    return np.random.default_rng(seed).permutation(traffic.quantile_lengths(n, spec, 0.0))


def make_texts(vocab: Sequence[str], counts: np.ndarray, seed: int) -> List[str]:
    """One text a count: that many words drawn uniformly from the vocabulary's
    words (never a special), joined by single spaces."""
    words = np.array(vocab[len(SPECIALS) :], dtype=object)
    ids = np.random.default_rng(seed).integers(0, len(words), int(counts.sum()))
    picked = words[ids].tolist()
    ends = np.cumsum(counts).tolist()
    out, a = [], 0
    for b in ends:
        out.append(" ".join(picked[a:b]))
        a = b
    return out


class TextQueries:
    """Texts (Python strings) and their word counts beside their TF-IDF rows
    ``X`` (n, D) CSR, row for row."""

    def __init__(self, texts: List[str], n_words: np.ndarray, X: smat.csr_matrix):
        self.texts, self.n_words, self.X = texts, n_words, X

    @property
    def shape(self):
        return (self.X.shape[0],)

    def __getitem__(self, rows: slice) -> "TextQueries":
        a, b, step = rows.indices(self.X.shape[0])
        if step != 1:
            raise IndexError("a pool is sliced by consecutive rows")
        return TextQueries(self.texts[a:b], self.n_words[a:b], self.X[a:b])


def match_level(sizes: Sequence[int], max_match_clusters: int) -> int:
    """The deepest level of the tree (the labels included) with at most
    ``max_match_clusters`` nodes: the matcher's last level."""
    return max(d for d, n in enumerate(sizes) if n <= max_match_clusters)


class Model(xrlinear.Model):
    """The ranker's tree and weights over D + H columns, the encoder, the
    vocabulary and tokenizer, and the matcher's head, from the seed."""

    def __init__(self, cfg: Dict, seed: int, device: torch.device):
        from pecos_tpu_torch.xmc.xtransformer import network

        super().__init__(cfg, seed, device)
        mc = cfg["model_config"]
        H = int(mc["hidden_size"])
        gen = torch.Generator(device=device)
        gen.manual_seed(sub_seed(seed, "weights", 1))
        total = sum(self.sizes)
        dense = (float(cfg["weight_std"]) * torch.randn((total, H), generator=gen, device=device)).cpu().numpy()
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
        del dense
        self.text_features = D
        self.D = D + H
        self.vocab = vocabulary(int(mc["vocab_size"]), sub_seed(seed, "weights", 2))
        self.encoder = network.random_encoder(cfg["encoder_type"], mc, seed=sub_seed(seed, "weights", 3))
        fd, path = tempfile.mkstemp(prefix="portbench-vocab-", suffix=".txt")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                f.write("\n".join(self.vocab) + "\n")
            self.tokenizer = network.wordpiece_tokenizer(path)
        finally:
            os.remove(path)
        n_match = self.sizes[match_level(self.sizes, int(cfg["max_match_clusters"]))]
        self.head = network.XMCHead.random(n_match, H, seed=sub_seed(seed, "weights", 4))


class Program:
    """The system under test: ``XTransformer.predict`` (concat-only) over the
    model's encoder, tokenizer, head and ranker, on ``device``.  ``wire`` is
    the ranker's query wire: "float32", as the configuration states, or
    "float16", the control."""

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
            copy.deepcopy(model.encoder), model.tokenizer, model.head,
            C=model.cluster_matrix(level) if level else None,
            pred_params=dict(truncate_length=int(cfg["truncate_length"]), only_topk=int(cfg["only_topk"]),
                             post_processor=cfg["post_processor"], ensemble_method="concat-only"),
            device=device,
        )
        self.xtf = XTransformer(matcher, ranker.xlm)
        self.kw = dict(ranker.kw, ens_method="concat-only")

    def predict(self, Q: TextQueries) -> smat.csr_matrix:
        return self.xtf.predict(Q.texts, X_feat=Q.X, **self.kw)


def queries(model: Model, n: int, lengths: np.ndarray, mix: Dict, seed: int, device) -> TextQueries:
    """n queries: TF-IDF rows with the lengths the loop drew, and texts whose
    word counts follow the mix's ``text_words``."""
    X = traffic.query_pool(n, lengths, model, seed, device)
    counts = word_counts(n, mix["text_words"], sub_seed(seed, "queries", 1))
    return TextQueries(make_texts(model.vocab, counts, sub_seed(seed, "queries", 2)), counts, X)


def row_sizes(Q: TextQueries) -> np.ndarray:
    """A query's TF-IDF nonzeros and words."""
    return np.diff(Q.X.indptr) + Q.n_words


def stack(parts: Sequence[TextQueries]) -> TextQueries:
    return TextQueries([t for p in parts for t in p.texts], np.concatenate([p.n_words for p in parts]),
                       smat.vstack([p.X for p in parts], format="csr"))


def arrays(Q: TextQueries) -> List[np.ndarray]:
    """The texts' UTF-8 bytes and offsets, then the CSR arrays."""
    raw = [t.encode("utf-8") for t in Q.texts]
    offsets = np.concatenate([[0], np.cumsum([len(r) for r in raw])]).astype(np.int64)
    return [np.frombuffer(b"".join(raw), np.uint8), offsets, Q.X.indptr, Q.X.indices, Q.X.data]
