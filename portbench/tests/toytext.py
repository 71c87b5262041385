"""A toy text-in model kind, for the tests alone: what XR-Transformer's
predict does, at a size the CPU holds, through the harness's kind contract
(``portbench/README.md``) and nothing else.

A query is a pair: a text, as ragged token ids, and its TF-IDF row.  The
program embeds the text (the mean of its tokens' rows of an embedding table,
then unit L2 norm: the encoder's place), appends the embedding to the TF-IDF
row as H dense columns, and ranks the concatenation with the port's
``XLinearModel.predict``, as XR-Transformer's concat ranker does.  The
configuration is an ``xrlinear`` one with ``vocab`` and ``embed_dim`` added;
the mix adds ``text_lengths`` (``min``, ``max``: tokens a text, uniform).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import scipy.sparse as smat
import torch

from portbench import traffic
from portbench.models import xrlinear


class TextQueries:
    """Texts as ragged token ids (``tok_ptr`` (n+1,), ``tok_ids``) beside
    their TF-IDF rows ``X`` (n, D) CSR, row for row."""

    def __init__(self, tok_ptr: np.ndarray, tok_ids: np.ndarray, X: smat.csr_matrix):
        self.tok_ptr, self.tok_ids, self.X = tok_ptr, tok_ids, X

    @property
    def shape(self):
        return (self.X.shape[0],)

    def __getitem__(self, rows: slice) -> "TextQueries":
        a, b, step = rows.indices(self.X.shape[0])
        if step != 1:
            raise IndexError("a pool is sliced by consecutive rows")
        p = self.tok_ptr
        return TextQueries(p[a : b + 1] - p[a], self.tok_ids[p[a] : p[b]], self.X[a:b])


class Model(xrlinear.Model):
    """An embedding table (``vocab``, H) and a ranker over D + H columns:
    ``xrlinear.Model``'s tree and sparse weights over the D TF-IDF features,
    then on every node H dense weights on the embedding's columns D..D+H-1,
    before the bias (now feature D + H).  ``D`` is the ranker's D + H."""

    def __init__(self, cfg: Dict, seed: int, device: torch.device):
        super().__init__(cfg, seed, device)
        H = int(cfg["embed_dim"])
        gen = torch.Generator(device=device)
        gen.manual_seed(traffic.sub_seed(seed, "weights") ^ 1)
        self.embed = torch.randn((int(cfg["vocab"]), H), generator=gen, device=device)
        total = sum(self.sizes)
        dense = (float(cfg["weight_std"]) * torch.randn((total, H), generator=gen, device=device)).cpu().numpy()
        bounds = np.cumsum([0] + self.sizes)
        D = self.D
        for d, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
            n = b - a
            cols = np.broadcast_to(np.arange(D, D + H, dtype=np.int32), (n, H))
            self.ids[d] = np.concatenate([self.ids[d][:, :-1], cols, np.full((n, 1), D + H, np.int32)], 1)
            self.vals[d] = np.concatenate([self.vals[d][:, :-1], dense[a:b], self.vals[d][:, -1:]], 1)
        self.text_features = D
        self.D = D + H


class Program:
    """Embed, normalise, concatenate, then the port's ``XLinearModel.predict``."""

    def __init__(self, model: Model, device: torch.device, wire: str = "float32"):
        self.ranker = xrlinear.Program(model, device, wire=wire)
        self.embed = model.embed
        self.device = device

    def features(self, Q: TextQueries) -> smat.csr_matrix:
        n = Q.shape[0]
        counts = torch.as_tensor(np.diff(Q.tok_ptr), device=self.device)
        row = torch.repeat_interleave(torch.arange(n, device=self.device), counts)
        tok = torch.as_tensor(Q.tok_ids.astype(np.int64), device=self.device)
        mean = torch.zeros((n, self.embed.shape[1]), device=self.device).index_add_(0, row, self.embed[tok])
        mean = mean / counts[:, None]
        emb = (mean / mean.norm(dim=1, keepdim=True)).cpu().numpy()
        return smat.hstack([Q.X, smat.csr_matrix(emb)], format="csr")

    def predict(self, Q: TextQueries) -> smat.csr_matrix:
        return self.ranker.predict(self.features(Q))


def queries(model: Model, n: int, lengths: np.ndarray, mix: Dict, seed: int, device) -> TextQueries:
    """n texts: TF-IDF rows with the lengths the loop drew, and token counts
    from the mix's ``text_lengths`` (fixed quantiles in a seeded order)."""
    X = traffic.query_pool(n, lengths, model, seed, device)
    tags = np.random.SeedSequence([traffic.sub_seed(seed, "queries"), 1]).generate_state(2, np.uint64) >> 1
    spec = dict(mix["text_lengths"], law="uniform")
    n_tok = np.random.default_rng(int(tags[0])).permutation(traffic.quantile_lengths(n, spec, 0.0))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(tags[1]))
    ids = torch.randint(0, model.embed.shape[0], (int(n_tok.sum()),), generator=gen, device=device)
    ptr = np.concatenate([[0], np.cumsum(n_tok)])
    return TextQueries(ptr, ids.to(torch.int32).cpu().numpy(), X)


def row_sizes(Q: TextQueries) -> np.ndarray:
    """A query's TF-IDF nonzeros and tokens."""
    return np.diff(Q.X.indptr) + np.diff(Q.tok_ptr)


def stack(parts: Sequence[TextQueries]) -> TextQueries:
    ptr = [np.zeros(1, np.int64)]
    for p in parts:
        ptr.append(p.tok_ptr[1:] + ptr[-1][-1])
    return TextQueries(np.concatenate(ptr), np.concatenate([p.tok_ids for p in parts]),
                       smat.vstack([p.X for p in parts], format="csr"))


def arrays(Q: TextQueries) -> List[np.ndarray]:
    return [Q.tok_ptr, Q.tok_ids, Q.X.indptr, Q.X.indices, Q.X.data]
