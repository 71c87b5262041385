"""Text vectorizers: native TF-IDF n-gram ensembles and sklearn wrappers.

The port of ``pecos_tpu/utils/featurization/text/vectorizers.py``.  ``Tfidf``
is an ensemble of base vectorizers (e.g. word 1-2 grams plus char 3-grams),
each with its own df pruning, idf and tf options; their feature blocks are
stacked side by side and the rows normalized again.

The port's host core (``pecos_tpu_torch/core``, ``csrc/tokenizer.cpp``) does
the hot loop: tokenize, enumerate n-grams, hash (FNV-1a 64) and count per
document.  df pruning, idf, the byte-lexicographic column order and the CSR
assembly stay vectorized numpy here.  There is no fallback: a core that does
not build raises.

The pure-Python counter below (``_tokenize``/``_ngrams``, reached through
``Tfidf.train_plain`` and ``Tfidf.predict_plain``) is the plain version of
the native tokenizer, for tests to hold it against.  It follows the native
token rule: a word is a maximal run of ASCII letters, digits, ``_`` and
non-ASCII codepoints, so non-ASCII punctuation ("—", "…", "«") is part of a
word, unlike Python's ``\\w``.  Text is lower-cased in Python before either
path sees it.
"""

from __future__ import annotations

import ctypes
import dataclasses as dc
import json
import logging
import os
import re
from collections import Counter
from typing import List, Optional, Sequence

import numpy as np
import scipy.sparse as smat

import pecos_tpu_torch
from pecos_tpu_torch.core import load_library
from pecos_tpu_torch.utils import smat_util

LOGGER = logging.getLogger(__name__)

_ANALYZER_CODE = {"word": 0, "char": 1, "char_wb": 2}
# the native word rule (tokenizer.cpp is_word_byte_start): ASCII word bytes
# and every non-ASCII codepoint
_WORD_RE = re.compile("[0-9A-Za-z_\u0080-\U0010ffff]+")

_u64p = ctypes.POINTER(ctypes.c_uint64)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)


def _packed(strings: Sequence[bytes]):
    """(blob, offsets int64 (n+1,)) of byte strings laid end to end."""
    offsets = np.zeros(len(strings) + 1, np.int64)
    if strings:
        offsets[1:] = np.cumsum([len(b) for b in strings])
    return b"".join(strings), offsets


def _native_count(corpus, analyzer: str, lo: int, hi: int, truncate: int, want_strings: bool):
    """Tokenize and count a corpus natively.

    Returns (doc_indptr, hashes, counts[, (blob, offsets, hashes, dfs)]):
    each document's unique n-gram hashes and multiplicities, and with
    ``want_strings`` the first-occurrence n-gram strings with their hashes
    and document frequencies."""
    lib = load_library()
    blob, offsets = _packed([t.lower().encode("utf-8") for t in corpus])
    n = len(corpus)
    handle = lib.tok_count(
        blob, offsets.ctypes.data_as(_i64p), n, _ANALYZER_CODE[analyzer], lo, hi, truncate, int(want_strings)
    )
    try:
        nnz = lib.tok_nnz(handle)
        doc_indptr = np.zeros(n + 1, np.int64)
        hashes = np.zeros(nnz, np.uint64)
        counts = np.zeros(nnz, np.int32)
        lib.tok_fill(handle, doc_indptr.ctypes.data_as(_i64p), hashes.ctypes.data_as(_u64p), counts.ctypes.data_as(_i32p))
        if not want_strings:
            return doc_indptr, hashes, counts
        n_uniq = lib.tok_n_unique(handle)
        blob_sz = int(lib.tok_str_blob_size(handle))
        sblob = ctypes.create_string_buffer(max(blob_sz, 1))
        soffs = np.zeros(n_uniq + 1, np.int64)
        shash = np.zeros(n_uniq, np.uint64)
        sdfs = np.zeros(n_uniq, np.int64)
        lib.tok_fill_strings(
            handle, sblob, soffs.ctypes.data_as(_i64p), shash.ctypes.data_as(_u64p), sdfs.ctypes.data_as(_i64p)
        )
        return doc_indptr, hashes, counts, (sblob.raw[:blob_sz], soffs, shash, sdfs)
    finally:
        lib.tok_free(handle)


def _flat_rows(lens: np.ndarray) -> np.ndarray:
    """Row id (int32) of each element of variable-length rows laid end to
    end; a row of length 0 takes no element.  (The JAX package's version marks
    row starts in a cumsum, which gives every document after an empty one the
    id of the document before it.)"""
    return np.repeat(np.arange(len(lens), dtype=np.int32), lens)


def _void_keys(blob: bytes, offs: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """memcmp-sortable keys of the tokens ``idx``: right-zero-padded UTF-8
    bytes viewed as a void dtype (byte order is codepoint order, and the zero
    pad sorts a shorter string first, as Python orders str)."""
    lens = offs[idx + 1] - offs[idx]
    n = len(idx)
    maxlen = int(lens.max()) if n else 1
    mat = np.zeros((max(n, 1), maxlen), np.uint8)
    if n:
        rows = _flat_rows(lens)
        starts = np.zeros(n, np.int64)
        np.cumsum(lens[:-1], out=starts[1:])
        within = np.arange(int(lens.sum()), dtype=np.int64) - starts[rows]
        mat[rows, within] = np.frombuffer(blob, np.uint8)[offs[idx][rows] + within]
    return mat[:n].view(f"V{maxlen}").ravel()


def _hash_tokens(tokens: List[str]) -> np.ndarray:
    """FNV-1a 64 hashes of vocabulary tokens through the native core."""
    blob, offsets = _packed([t.encode("utf-8") for t in tokens])
    out = np.zeros(len(tokens), np.uint64)
    load_library().tok_hash_strings(blob, offsets.ctypes.data_as(_i64p), len(tokens), out.ctypes.data_as(_u64p))
    return out


class _Lookup:
    """The native hash -> column table of one vocabulary (``tok_lookup_build``),
    freed with this object."""

    def __init__(self, hashes: np.ndarray, cols: np.ndarray):
        self._lib = load_library()
        hs = np.ascontiguousarray(hashes, np.uint64)
        self._handle = ctypes.c_void_p(self._lib.tok_lookup_build(hs.ctypes.data_as(_u64p), len(hs)))
        self._cols = np.ascontiguousarray(cols, np.int64)

    def __call__(self, hashes: np.ndarray) -> np.ndarray:
        q = np.ascontiguousarray(hashes, np.uint64)
        out = np.zeros(len(q), np.int64)
        self._lib.tok_lookup(self._handle, q.ctypes.data_as(_u64p), len(q), out.ctypes.data_as(_i64p))
        found = out >= 0
        out[found] = self._cols[out[found]]
        return out

    def __del__(self):
        self._lib.tok_lookup_free(self._handle)


def _df_bounds(params: "TfidfBaseParams", n_doc: int):
    min_df = max(params.min_df_cnt, int(np.ceil(params.min_df_ratio * n_doc)))
    max_df = n_doc if params.max_df_cnt < 0 else params.max_df_cnt
    return min_df, min(max_df, int(np.floor(params.max_df_ratio * n_doc)))


def _idf(params: "TfidfBaseParams", dfs: np.ndarray, n_doc: int) -> np.ndarray:
    if not params.use_idf:
        return np.ones(len(dfs), np.float32)
    s = 1.0 if params.smooth_idf else 0.0
    idf = np.log((n_doc + s) / (np.asarray(dfs, np.float64) + s))
    if params.add_one_idf:
        idf += 1.0
    return idf.astype(np.float32)


class Vectorizer(pecos_tpu_torch.BaseClass):
    """Registry of vectorizer types and the folder format ``config.json`` + ``model/``."""

    vectorizer_dict = {}

    @classmethod
    def register(cls, name):
        def deco(sub):
            cls.vectorizer_dict[name] = sub
            return sub

        return deco

    @classmethod
    def train(cls, trn_corpus, config: Optional[dict] = None, dtype=np.float32):
        config = config if config is not None else {"type": "tfidf", "kwargs": {}}
        ty = config.get("type", "tfidf")
        if ty not in cls.vectorizer_dict:
            raise ValueError(f"unknown vectorizer type {ty!r}")
        model = cls.vectorizer_dict[ty].train(trn_corpus, config.get("kwargs", {}), dtype=dtype)
        return cls(config, model)

    def __init__(self, config, model):
        self.config = config
        self.model = model

    def predict(self, corpus, **kwargs):
        return self.model.predict(corpus, **kwargs)

    def save(self, folder):
        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, "config.json"), "w") as f:
            json.dump(self.config, f)
        self.model.save(os.path.join(folder, "model"))

    @classmethod
    def load(cls, folder):
        with open(os.path.join(folder, "config.json")) as f:
            config = json.load(f)
        model = cls.vectorizer_dict[config["type"]].load(os.path.join(folder, "model"))
        return cls(config, model)


@dc.dataclass
class TfidfBaseParams(pecos_tpu_torch.BaseParams):
    """One base vectorizer's params."""

    ngram_range: Sequence[int] = (1, 1)
    truncate_length: int = -1  # max tokens (word) / chars (char); -1 = no cap
    max_feature: int = 0  # keep top-k features by df (0 = all)
    min_df_ratio: float = 0.0
    max_df_ratio: float = 1.0
    min_df_cnt: int = 0
    max_df_cnt: int = -1  # -1 = no cap
    binary: bool = False
    use_idf: bool = True
    smooth_idf: bool = True
    add_one_idf: bool = False
    sublinear_tf: bool = False
    keep_frequent_feature: bool = True
    norm: str = "l2"
    analyzer: str = "word"  # word | char | char_wb


def _tokenize(text: str, analyzer: str, truncate: int) -> List[str]:
    """The plain version's units of one document: words (word), the
    document's codepoints (char) or space-padded words (char_wb)."""
    text = text.lower()
    if analyzer == "char":
        return list(text[:truncate] if truncate > 0 else text)
    if analyzer not in ("word", "char_wb"):
        raise ValueError(f"unknown analyzer {analyzer!r}")
    toks = _WORD_RE.findall(text)
    if truncate > 0:
        toks = toks[:truncate]
    return toks if analyzer == "word" else [f" {t} " for t in toks]


def _ngrams(units: List[str], analyzer: str, lo: int, hi: int):
    if analyzer == "word":
        for n in range(lo, hi + 1):
            for i in range(len(units) - n + 1):
                yield " ".join(units[i : i + n])
    else:  # char n-grams of the document, or of each padded word (char_wb)
        for s in ["".join(units)] if analyzer == "char" else units:
            for n in range(lo, hi + 1):
                for i in range(len(s) - n + 1):
                    yield s[i : i + n]


class _TfidfBase:
    """One trained base vectorizer: vocabulary and idf weights.

    Token strings live in a dict (plain train, or a loaded model) or packed
    as (blob, offsets) in column order (native train); the dict is built on
    first use, since the native predict needs the hashes only."""

    def __init__(self, params: TfidfBaseParams, vocab: Optional[dict], idf: np.ndarray):
        self.params = params
        self._vocab = vocab
        self.idf = idf
        self._tok_storage: Optional[tuple] = None  # (blob bytes, offsets) in column order
        self._hash_sorted: Optional[np.ndarray] = None
        self._col_sorted: Optional[np.ndarray] = None

    @property
    def vocab(self) -> dict:
        if self._vocab is None and self._tok_storage is not None:
            blob, offs = self._tok_storage
            self._vocab = {blob[offs[i] : offs[i + 1]].decode("utf-8"): i for i in range(len(offs) - 1)}
        return self._vocab

    @classmethod
    def _from_native_vocab(cls, params, blob, offs, shash, df, n_doc) -> "_TfidfBase":
        """Vocabulary selection without a loop over tokens: df pruning, the
        feature cap (ties in df broken by the token's bytes) and the
        byte-lexicographic column order (``tok_sort_order`` in C++)."""
        min_df, max_df = _df_bounds(params, n_doc)
        idx = np.nonzero((df >= min_df) & (df <= max_df))[0]
        if params.max_feature > 0 and len(idx) > params.max_feature:
            dkey = -df[idx] if params.keep_frequent_feature else df[idx]
            idx = idx[np.lexsort((_void_keys(blob, offs, idx), dkey))[: params.max_feature]]
        idx = np.ascontiguousarray(idx, np.int64)
        order = np.zeros(len(idx), np.int64)
        if len(idx):
            offs64 = np.ascontiguousarray(offs, np.int64)
            load_library().tok_sort_order(
                blob, offs64.ctypes.data_as(_i64p), idx.ctypes.data_as(_i64p), len(idx), order.ctypes.data_as(_i64p)
            )
        idx = idx[order]
        obj = cls(params, None, _idf(params, df[idx], n_doc))
        # repack the selected tokens in column order
        lens = offs[idx + 1] - offs[idx]
        new_offs = np.zeros(len(idx) + 1, np.int64)
        new_offs[1:] = np.cumsum(lens)
        packed = b""
        if len(idx):
            rows = _flat_rows(lens)
            pos = np.arange(int(lens.sum()), dtype=np.int64) - new_offs[:-1][rows] + offs[idx][rows]
            packed = np.frombuffer(blob, np.uint8)[pos].tobytes()
        obj._tok_storage = (packed, new_offs)
        h = shash[idx]
        horder = np.argsort(h)
        obj._hash_sorted = h[horder]
        obj._col_sorted = np.arange(len(idx), dtype=np.int64)[horder]
        return obj

    @classmethod
    def train(cls, corpus: Sequence[str], params: TfidfBaseParams) -> "_TfidfBase":
        """Native train.  The counter merges two n-grams whose 64-bit hashes
        collide (odds ~V^2/2^64), as a hashed vocabulary build does."""
        lo, hi = params.ngram_range
        _, _, _, (blob, soffs, shash, sdfs) = _native_count(
            corpus, params.analyzer, lo, hi, params.truncate_length, want_strings=True
        )
        return cls._from_native_vocab(params, blob, soffs, shash, sdfs, len(corpus))

    @classmethod
    def train_plain(cls, corpus: Sequence[str], params: TfidfBaseParams) -> "_TfidfBase":
        """The plain version of :meth:`train`: a Python counter over the same
        token rule, the same pruning and the same column order."""
        lo, hi = params.ngram_range
        df_ctr: Counter = Counter()
        for text in corpus:
            df_ctr.update(set(_ngrams(_tokenize(text, params.analyzer, params.truncate_length), params.analyzer, lo, hi)))
        min_df, max_df = _df_bounds(params, len(corpus))
        items = [(t, c) for t, c in df_ctr.items() if min_df <= c <= max_df]
        if params.max_feature > 0 and len(items) > params.max_feature:
            items.sort(key=lambda tc: (-tc[1] if params.keep_frequent_feature else tc[1], tc[0]))
            items = items[: params.max_feature]
        items.sort(key=lambda tc: tc[0])  # str order is codepoint order is UTF-8 byte order
        vocab = {t: i for i, (t, _) in enumerate(items)}
        return cls(params, vocab, _idf(params, np.array([c for _, c in items], np.int64), len(corpus)))

    @classmethod
    def train_file(cls, path: str, params: TfidfBaseParams, chunk_docs: int = 65536) -> "_TfidfBase":
        """Streaming train from a text file, one document per line, with at
        most ``chunk_docs`` documents resident at a time.  df counts and
        first-seen token strings accumulate across chunks and the vocabulary
        is selected once at the end, so the result equals the in-memory
        train on the same lines.  A hash collision within a chunk restarts
        the train in memory."""
        lo, hi = params.ngram_range

        def chunks():
            buf = []
            with open(path, encoding="utf-8") as f:
                for line in f:
                    buf.append(line.rstrip("\n"))
                    if len(buf) >= chunk_docs:
                        yield buf
                        buf = []
            if buf:
                yield buf

        n_doc = 0
        acc_h = np.zeros(0, np.uint64)  # sorted unique hashes seen so far
        acc_df = np.zeros(0, np.int64)  # their document frequencies
        acc_blob = bytearray()  # first-seen token strings, in order of first sight
        acc_offs: list = [0]
        acc_str_h: list = []  # hash arrays aligned with the stored strings
        for chunk in chunks():
            n_doc += len(chunk)
            _, hashes, _, (blob, soffs, shash, _) = _native_count(
                chunk, params.analyzer, lo, hi, params.truncate_length, want_strings=True
            )
            uh, df = np.unique(hashes, return_counts=True)
            if len(uh) != len(shash):
                # two n-grams of this chunk share a 64-bit hash: the string
                # set merged them, so restart in memory
                LOGGER.warning("tfidf hash collision during streaming train; re-training in memory")
                with open(path, encoding="utf-8") as f:
                    return cls.train([line.rstrip("\n") for line in f], params)
            pos = np.searchsorted(acc_h, uh)
            safe = np.minimum(pos, max(len(acc_h) - 1, 0))
            found = (pos < len(acc_h)) & (acc_h[safe] == uh) if len(acc_h) else np.zeros(len(uh), bool)
            acc_df[pos[found]] += df[found]
            spos = np.searchsorted(acc_h, shash)
            ssafe = np.minimum(spos, max(len(acc_h) - 1, 0))
            s_new = ~((spos < len(acc_h)) & (acc_h[ssafe] == shash)) if len(acc_h) else np.ones(len(shash), bool)
            new_idx = np.nonzero(s_new)[0]
            if len(new_idx):
                lens = (soffs[new_idx + 1] - soffs[new_idx]).astype(np.int64)
                within = np.arange(lens.sum()) - np.repeat(np.cumsum(lens) - lens, lens)
                acc_blob += np.frombuffer(blob, np.uint8)[np.repeat(soffs[new_idx], lens) + within].tobytes()
                acc_offs.extend((acc_offs[-1] + np.cumsum(lens)).tolist())
                acc_str_h.append(shash[new_idx])
                nh = np.sort(shash[new_idx])
                merged_h = np.concatenate([acc_h, nh])
                merged_df = np.concatenate([acc_df, df[np.searchsorted(uh, nh)]])
                morder = np.argsort(merged_h, kind="stable")
                acc_h, acc_df = merged_h[morder], merged_df[morder]
        if not n_doc:
            return cls(params, {}, np.zeros(0, np.float32))
        str_h = np.concatenate(acc_str_h) if acc_str_h else np.zeros(0, np.uint64)
        df_of_token = acc_df[np.searchsorted(acc_h, str_h)] if len(acc_h) else np.zeros(0, np.int64)
        return cls._from_native_vocab(params, bytes(acc_blob), np.asarray(acc_offs, np.int64), str_h, df_of_token, n_doc)

    @property
    def nr_features(self) -> int:
        if self._vocab is None and self._tok_storage is not None:
            return len(self._tok_storage[1]) - 1
        return len(self._vocab)

    def _lookup_cols(self, hashes: np.ndarray) -> np.ndarray:
        """Column id of each n-gram hash (-1 when absent), through the
        native open-addressing table, built once per model."""
        if not self.nr_features:
            return np.full(len(hashes), -1, np.int64)
        if getattr(self, "_lookup", None) is None:
            if self._hash_sorted is None:
                h = _hash_tokens(list(self.vocab.keys()))
                order = np.argsort(h)
                self._hash_sorted = h[order]
                self._col_sorted = np.fromiter(self.vocab.values(), np.int64, len(self.vocab))[order]
            self._lookup = _Lookup(self._hash_sorted, self._col_sorted)
        return self._lookup(hashes)

    def __getstate__(self):
        # the native lookup table is a pointer, so it is not pickled; it is
        # built again at the first predict after unpickling
        state = dict(self.__dict__)
        state.pop("_lookup", None)
        return state

    def _weigh(self, rows, cols, counts, n_docs: int) -> smat.csr_matrix:
        """CSR of tf x idf from per-document n-gram counts, rows normalized."""
        p = self.params
        tf = counts.astype(np.float32)
        if p.binary:
            tf = np.ones_like(tf)
        elif p.sublinear_tf:
            tf = 1.0 + np.log(tf)
        vals = tf * self.idf[cols] if p.use_idf else tf
        X = smat.csr_matrix((vals, (rows, cols)), shape=(n_docs, self.nr_features))
        if p.norm in ("l1", "l2"):
            X = smat_util.normalize(X, axis=1, norm=p.norm)
        return X

    def predict(self, corpus: Sequence[str]) -> smat.csr_matrix:
        p = self.params
        lo, hi = p.ngram_range
        doc_indptr, hashes, counts = _native_count(corpus, p.analyzer, lo, hi, p.truncate_length, want_strings=False)
        mapped = self._lookup_cols(hashes)
        valid = mapped >= 0
        rows = _flat_rows(np.diff(doc_indptr))[valid]
        return self._weigh(rows, mapped[valid], counts[valid], len(corpus))

    def predict_plain(self, corpus: Sequence[str]) -> smat.csr_matrix:
        """The plain version of :meth:`predict`: a Python counter per document
        over the vocabulary's strings."""
        p = self.params
        lo, hi = p.ngram_range
        vocab = self.vocab
        rows, cols, counts = [], [], []
        for i, text in enumerate(corpus):
            cnt = Counter(vocab[g] for g in _ngrams(_tokenize(text, p.analyzer, p.truncate_length), p.analyzer, lo, hi) if g in vocab)
            rows.extend([i] * len(cnt))
            cols.extend(cnt.keys())
            counts.extend(cnt.values())
        return self._weigh(np.array(rows, np.int64), np.array(cols, np.int64), np.array(counts, np.int32), len(corpus))

    def to_dict(self):
        # params without the writing package's class name, so either package reads them
        return {"params": self.params.to_dict(with_meta=False), "vocab": list(self.vocab.keys()), "idf": self.idf.tolist()}

    @classmethod
    def from_dict(cls, d):
        vocab = {t: i for i, t in enumerate(d["vocab"])}
        return cls(TfidfBaseParams.from_dict(d["params"]), vocab, np.array(d["idf"], np.float32))


@Vectorizer.register("tfidf")
class Tfidf(pecos_tpu_torch.BaseClass):
    """Ensemble TF-IDF vectorizer over the native tokenizer."""

    def __init__(self, bases: List[_TfidfBase], norm: str = "l2"):
        self.bases = bases
        self.norm = norm

    @staticmethod
    def _params(config: Optional[dict]):
        """(base params, norm, chunk_docs) of a config: ``base_vect_configs``
        lists the members, else the config itself is the one member."""
        config = dict(config or {})
        norm = config.pop("norm", "l2")
        chunk_docs = int(config.pop("chunk_docs", 65536))
        base_cfgs = config.pop("base_vect_configs", None)
        if base_cfgs is None:
            base_cfgs = [config] if config else [{}]
        return [TfidfBaseParams.from_dict({**bc, "norm": bc.get("norm", norm)}) for bc in base_cfgs], norm, chunk_docs

    @classmethod
    def train(cls, trn_corpus, config: Optional[dict] = None, dtype=np.float32) -> "Tfidf":
        """Train on a list of documents, or on a file path (one document per
        line) through the streaming train."""
        params, norm, chunk_docs = cls._params(config)
        if isinstance(trn_corpus, str):
            bases = [_TfidfBase.train_file(trn_corpus, p, chunk_docs=chunk_docs) for p in params]
        else:
            corpus = list(trn_corpus)
            bases = [_TfidfBase.train(corpus, p) for p in params]
        return cls(bases, norm=norm)

    @classmethod
    def train_plain(cls, trn_corpus, config: Optional[dict] = None) -> "Tfidf":
        """The plain version of :meth:`train` (Python counters)."""
        params, norm, _ = cls._params(config)
        corpus = cls._as_corpus(trn_corpus)
        return cls([_TfidfBase.train_plain(corpus, p) for p in params], norm=norm)

    @staticmethod
    def _as_corpus(corpus) -> List[str]:
        if isinstance(corpus, str):
            with open(corpus, encoding="utf-8") as f:
                return [line.rstrip("\n") for line in f]
        return list(corpus)

    @property
    def nr_features(self) -> int:
        return sum(b.nr_features for b in self.bases)

    def _stack(self, blocks: List[smat.csr_matrix]) -> smat.csr_matrix:
        if len(blocks) == 1:
            return blocks[0]
        X = smat_util.hstack_csr(blocks)
        if self.norm in ("l1", "l2"):  # the ensemble's rows normalized again
            X = smat_util.normalize(X, axis=1, norm=self.norm)
        return X

    def predict(self, corpus, **kwargs) -> smat.csr_matrix:
        corpus = self._as_corpus(corpus)
        return self._stack([b.predict(corpus) for b in self.bases])

    def predict_plain(self, corpus) -> smat.csr_matrix:
        """The plain version of :meth:`predict` (Python counters)."""
        corpus = self._as_corpus(corpus)
        return self._stack([b.predict_plain(corpus) for b in self.bases])

    def save(self, folder):
        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, "tfidf_model.json"), "w") as f:
            json.dump({"norm": self.norm, "bases": [b.to_dict() for b in self.bases]}, f)

    @classmethod
    def load(cls, folder):
        with open(os.path.join(folder, "tfidf_model.json")) as f:
            payload = json.load(f)
        return cls([_TfidfBase.from_dict(b) for b in payload["bases"]], payload["norm"])


class _SklearnVectorizer(pecos_tpu_torch.BaseClass):
    """A pickled sklearn vectorizer; sklearn is imported only when one is trained."""

    def __init__(self, model):
        self.model = model

    @classmethod
    def _sklearn_class(cls):
        raise NotImplementedError

    @classmethod
    def train(cls, trn_corpus, config=None, dtype=np.float32):
        config = dict(config or {})
        config.setdefault("dtype", dtype)
        if "ngram_range" in config:
            config["ngram_range"] = tuple(config["ngram_range"])
        model = cls._sklearn_class()(**config)
        model.fit(Tfidf._as_corpus(trn_corpus))
        return cls(model)

    def predict(self, corpus, **kwargs):
        return self.model.transform(Tfidf._as_corpus(corpus)).astype(np.float32)

    def save(self, folder):
        import pickle

        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, "model.pkl"), "wb") as f:
            pickle.dump(self.model, f)

    @classmethod
    def load(cls, folder):
        import pickle

        with open(os.path.join(folder, "model.pkl"), "rb") as f:
            return cls(pickle.load(f))


@Vectorizer.register("sklearn_tfidf")
class SklearnTfidf(_SklearnVectorizer):
    """sklearn's TfidfVectorizer."""

    @classmethod
    def _sklearn_class(cls):
        from sklearn.feature_extraction.text import TfidfVectorizer

        return TfidfVectorizer


@Vectorizer.register("sklearn_hashing")
class SklearnHashing(_SklearnVectorizer):
    """sklearn's HashingVectorizer."""

    @classmethod
    def _sklearn_class(cls):
        from sklearn.feature_extraction.text import HashingVectorizer

        return HashingVectorizer
