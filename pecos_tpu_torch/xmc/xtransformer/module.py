"""Data containers for text XMC training (counterpart of
``pecos_tpu/xmc/xtransformer/module.py``).

Host numpy, as in the JAX package: the corpus is tokenized once into
fixed-shape (N, truncate_length) int32 arrays, and each instance's active
labels (its positives, then negatives from the matched clusters) are padded
with the padding label ``nr_labels`` to one width.  With one numpy generator
state these functions give the JAX package's arrays bit for bit, and the npz
token cache and the shard folders have its layout.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as smat

from pecos_tpu_torch.utils import profile_util, smat_util


@dataclasses.dataclass
class MLProblemWithText:
    """Text + (optionally) numerical features + labels for one training level."""

    X_text: Sequence[str]
    Y: smat.csr_matrix
    X_feat: Optional[smat.spmatrix] = None

    def __post_init__(self):
        self.Y = self.Y.tocsr()
        if len(self.X_text) != self.Y.shape[0]:
            raise ValueError("X_text and Y row count mismatch")

    @property
    def nr_labels(self):
        return self.Y.shape[1]


def _cache_path(tokenizer, corpus: Sequence[str], truncate_length: int, cache_dir: str) -> str:
    """The JAX package's cache key: sha256 of the tokenizer class name, the
    length and each text with a zero byte after it."""
    h = hashlib.sha256()
    h.update(type(tokenizer).__name__.encode())
    h.update(str(truncate_length).encode())
    for t in corpus:
        h.update(t.encode("utf-8", "ignore"))
        h.update(b"\x00")
    return os.path.join(cache_dir, f"tokens_{h.hexdigest()[:24]}.npz")


def tokenize_corpus(tokenizer, corpus: Sequence[str], truncate_length: int = 128, cache_dir: Optional[str] = None):
    """``{"input_ids", "attention_mask"}``, each (len(corpus), truncate_length)
    int32, padded to the full length.  With ``cache_dir`` the arrays are kept
    in an npz keyed by a hash of (tokenizer class, length, corpus) and read
    back on the next call.  Span ``pecos.tokenize``."""
    with profile_util.span("pecos.tokenize"):
        path = None if cache_dir is None else _cache_path(tokenizer, corpus, truncate_length, cache_dir)
        if path is not None and os.path.exists(path):
            with np.load(path) as z:
                return {"input_ids": z["input_ids"], "attention_mask": z["attention_mask"]}
        enc = tokenizer(list(corpus), padding="max_length", truncation=True, max_length=truncate_length,
                        return_tensors="np")
        out = {k: np.asarray(enc[k]).astype(np.int32) for k in ("input_ids", "attention_mask")}
        if path is not None:
            os.makedirs(cache_dir, exist_ok=True)
            np.savez(path, **out)
        return out


class CorpusTokens:
    """A corpus tokenized a block at a time, in place of the whole corpus's
    arrays: ``network.encode_batches`` asks for each block of texts after it
    has enqueued the forward before it, so the host's tokenizer runs while
    the card encodes.  ``block(start, end)`` is ``tokenize_corpus`` over
    those texts (span ``pecos.tokenize`` a block)."""

    def __init__(self, tokenizer, corpus: Sequence[str], truncate_length: int = 128):
        self.tokenizer, self.corpus, self.truncate_length = tokenizer, list(corpus), truncate_length

    def __len__(self) -> int:
        return len(self.corpus)

    def block(self, start: int, end: int) -> dict:
        return tokenize_corpus(self.tokenizer, self.corpus[start:end], self.truncate_length)


class XMCTextDataset:
    """Tokenized text with its label (Y), matching (M) and relevance (R)
    matrices, cut into shards: ``get_shard(start, end)``, ``save(dir,
    num_shards)`` and ``load(dir, shard)``, so a trainer can stage one shard
    per worker.  A shard folder holds ``tokens.npz`` and ``{Y,M,R}.npz``."""

    _MATS = ("Y", "M", "R")

    def __init__(self, tokens: dict, Y=None, M=None, R=None):
        n = tokens["input_ids"].shape[0]
        for name, mat in zip(self._MATS, (Y, M, R)):
            if mat is not None and mat.shape[0] != n:
                raise ValueError(f"{name} rows ({mat.shape[0]}) != instances ({n})")
        self.tokens = tokens
        self.Y, self.M, self.R = (None if m is None else m.tocsr() for m in (Y, M, R))

    @classmethod
    def from_text(cls, tokenizer, corpus, truncate_length=128, Y=None, M=None, R=None, cache_dir=None):
        return cls(tokenize_corpus(tokenizer, corpus, truncate_length, cache_dir=cache_dir), Y=Y, M=M, R=R)

    def __len__(self):
        return self.tokens["input_ids"].shape[0]

    def _mats(self):
        return dict(zip(self._MATS, (self.Y, self.M, self.R)))

    def get_shard(self, start: int, end: int) -> "XMCTextDataset":
        sl = slice(start, end)
        return type(self)({k: v[sl] for k, v in self.tokens.items()},
                          **{k: None if m is None else m[sl] for k, m in self._mats().items()})

    def save(self, save_dir: str, num_shards: Optional[int] = None, init_shard_idx: int = 0):
        num_shards = num_shards or 1
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, "config.json"), "w") as f:
            json.dump({"model": type(self).__name__, "num_shards": num_shards, "num_instances": len(self)}, f, indent=True)
        chunk = -(-len(self) // num_shards)
        for sid in range(init_shard_idx, init_shard_idx + num_shards):
            shard = self.get_shard(chunk * sid, min(chunk * (sid + 1), len(self)))
            sdir = os.path.join(save_dir, str(sid))
            os.makedirs(sdir, exist_ok=True)
            np.savez(os.path.join(sdir, "tokens.npz"), **shard.tokens)
            for name, mat in shard._mats().items():
                if mat is not None:
                    smat_util.save_matrix(os.path.join(sdir, f"{name}.npz"), mat)

    @classmethod
    def get_data_stats(cls, load_dir: str) -> dict:
        with open(os.path.join(load_dir, "config.json")) as f:
            return json.load(f)

    @classmethod
    def load(cls, load_dir: str, shard: int = 0) -> "XMCTextDataset":
        nr = cls.get_data_stats(load_dir)["num_shards"]
        if shard >= nr:
            raise ValueError(f"shard#{shard} requested but only {nr} shards saved")
        sdir = os.path.join(load_dir, str(shard))
        with np.load(os.path.join(sdir, "tokens.npz")) as z:
            tokens = {k: z[k] for k in z.files}
        mats = {}
        for name in cls._MATS:
            p = os.path.join(sdir, f"{name}.npz")
            mats[name] = smat_util.load_matrix(p).tocsr() if os.path.exists(p) else None
        return cls(tokens, **mats)

    def label_batches(self, max_active: int, pad_label: int, rng, Cp: float = 1.0, Cn: float = 1.0):
        """Active-label arrays for this shard (see build_active_label_batches)."""
        if self.Y is None:
            raise ValueError("label_batches requires Y")
        return build_active_label_batches(self.Y, self.M, self.R, max_active, pad_label, rng, Cp=Cp, Cn=Cn)


def build_active_label_batches(
    Y: smat.csr_matrix,
    M: Optional[smat.csr_matrix],
    R: Optional[smat.csr_matrix],
    max_active: int,
    pad_label: int,
    rng: np.random.Generator,
    Cp: float = 1.0,
    Cn: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Each instance's active labels: its positives (Y's row), then negatives
    (M's row, already in label space, less the positives; every other label
    without M), subsampled by ``rng`` where they overflow ``max_active`` and
    padded with ``pad_label``.

    Returns (label_ids (N, max_active) int32, targets +1 / -1 float32, costs
    float32: Cp (times R's entry where R is given) for a positive, Cn for a
    negative, 0 at padding).  ``rng`` is drawn from in the JAX package's
    order, so one generator state gives its arrays."""
    N, L = Y.shape
    label_ids = np.full((N, max_active), pad_label, np.int32)
    targets = np.ones((N, max_active), np.float32)
    costs = np.zeros((N, max_active), np.float32)
    M = M.tocsr() if M is not None else None
    R = R.tocsr() if R is not None else None
    for i in range(N):
        pos = Y.indices[Y.indptr[i] : Y.indptr[i + 1]]
        cand = M.indices[M.indptr[i] : M.indptr[i + 1]] if M is not None else np.arange(L)
        neg = np.setdiff1d(cand, pos)
        if len(pos) > max_active:
            pos = rng.choice(pos, size=max_active, replace=False)
        n_neg = max_active - len(pos)
        if len(neg) > n_neg:
            neg = rng.choice(neg, size=n_neg, replace=False)
        n_pos, n_ids = len(pos), len(pos) + len(neg)
        label_ids[i, :n_ids] = np.concatenate([pos, neg])
        targets[i, n_pos:n_ids] = -1.0
        if R is not None and n_pos:
            costs[i, :n_pos] = Cp * R[i].toarray().ravel()[pos]
        else:
            costs[i, :n_pos] = Cp
        costs[i, n_pos:n_ids] = Cn
    return label_ids, targets, costs
