"""SentencePiece vectorizer: subword pieces as bag-of-pieces TF(-IDF) features.

The port of ``pecos_tpu/utils/featurization/text/sentencepiece_util.py``.
The ``sentencepiece`` package is optional: without it, training or predicting
raises the same ``ImportError`` with install guidance.  With it, the
vectorizer registers as ``"sentencepiece"`` in the Vectorizer registry when
this module is imported.
"""

from __future__ import annotations

import io
import os
from collections import Counter
from typing import List, Optional, Sequence

import numpy as np
import scipy.sparse as smat

import pecos_tpu_torch
from pecos_tpu_torch.utils import smat_util
from .vectorizers import Vectorizer


def _require_spm():
    try:
        import sentencepiece as spm

        return spm
    except ImportError as e:
        raise ImportError(
            "sentencepiece is not installed in this environment; "
            "`pip install sentencepiece` to use the SentencePiece vectorizer"
        ) from e


@Vectorizer.register("sentencepiece")
class SentencePieceVectorizer(pecos_tpu_torch.BaseClass):
    """Subword tokenizer + bag-of-pieces TF (optionally idf-weighted) features."""

    def __init__(self, sp_model_bytes: bytes, vocab_size: int, use_idf: bool, idf=None):
        self._bytes = sp_model_bytes
        self.vocab_size = vocab_size
        self.use_idf = use_idf
        self.idf = idf
        self._sp = None

    def _proc(self):
        if self._sp is None:
            spm = _require_spm()
            self._sp = spm.SentencePieceProcessor(model_proto=self._bytes)
        return self._sp

    @classmethod
    def train(cls, trn_corpus, config: Optional[dict] = None, dtype=np.float32):
        spm = _require_spm()
        config = dict(config or {})
        vocab_size = config.get("vocab_size", 8000)
        if isinstance(trn_corpus, list):
            corpus = trn_corpus
        else:
            with open(trn_corpus, encoding="utf-8") as f:
                corpus = f.read().splitlines()
        model = io.BytesIO()
        spm.SentencePieceTrainer.train(
            sentence_iterator=iter(corpus),
            model_writer=model,
            vocab_size=vocab_size,
            model_type=config.get("model_type", "unigram"),
        )
        obj = cls(model.getvalue(), vocab_size, config.get("use_idf", True))
        if obj.use_idf:
            n = len(corpus)
            df = np.zeros(vocab_size)
            sp = obj._proc()
            for line in corpus:
                for t in set(sp.encode(line)):
                    df[t] += 1
            obj.idf = np.log((n + 1.0) / (df + 1.0)).astype(np.float32)
        return obj

    def predict(self, corpus: Sequence[str], **kwargs) -> smat.csr_matrix:
        sp = self._proc()
        indptr = [0]
        indices: List[int] = []
        data: List[float] = []
        for line in corpus:
            cnt = Counter(sp.encode(line))
            ks = sorted(cnt)
            vals = np.array([cnt[k] for k in ks], np.float32)
            if self.use_idf and self.idf is not None:
                vals = vals * self.idf[ks]
            indices.extend(ks)
            data.extend(vals.tolist())
            indptr.append(len(indices))
        X = smat.csr_matrix(
            (np.array(data, np.float32), np.array(indices, np.int64), np.array(indptr)),
            shape=(len(corpus), self.vocab_size),
        )
        return smat_util.normalize(X, axis=1, norm="l2")

    def save(self, folder):
        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, "sp.model"), "wb") as f:
            f.write(self._bytes)
        np.savez(
            os.path.join(folder, "meta.npz"),
            vocab_size=self.vocab_size,
            use_idf=self.use_idf,
            idf=self.idf if self.idf is not None else np.zeros(0),
        )

    @classmethod
    def load(cls, folder):
        with open(os.path.join(folder, "sp.model"), "rb") as f:
            b = f.read()
        z = np.load(os.path.join(folder, "meta.npz"))
        idf = z["idf"] if z["idf"].size else None
        return cls(b, int(z["vocab_size"]), bool(z["use_idf"]), idf)
