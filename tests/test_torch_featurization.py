"""The port's Tfidf, Vectorizer and Preprocessor against the JAX package's on
the same corpora, and the native tokenizer against its plain Python version.

Both packages tokenize with the same native rule (the JAX package's core
always builds here), so the CSR must be equal: indices exact, data within
rtol 1e-6 (both run the same float32 numpy arithmetic; the bound leaves room
for a reordered sum).
"""

import json
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pecos_tpu.utils.featurization.text import Preprocessor as JPreprocessor
from pecos_tpu.utils.featurization.text import Tfidf as JTfidf
from pecos_tpu.utils.featurization.text import Vectorizer as JVectorizer
from pecos_tpu_torch.utils import smat_util
from pecos_tpu_torch.utils.featurization.text import Preprocessor, Tfidf, Vectorizer
from pecos_tpu_torch.utils.featurization.text import vectorizers

REPO = Path(__file__).resolve().parents[1]

CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "never jump over the lazy dog quickly",
    "bright foxes leap over lazy dogs in summer",
    "the dog sleeps in the sun",
    "The DOG — «sleeps» … in the sun, naïve café",
    "em—dash joins words; ellipsis…too and «guillemets»",
]
# documents without an n-gram: the JAX package's native predict gives every
# document after one the row of the one before it, and fails on one at the end
# (ROADMAP F9), so they are held against the plain version only
EMPTY = ["", "the dog", "", " ,;", "x"]

CONFIGS = {
    "word": {"ngram_range": [1, 2]},
    "char": {"ngram_range": [2, 4], "analyzer": "char"},
    "char_wb": {"ngram_range": [1, 3], "analyzer": "char_wb"},
    "truncate": {"ngram_range": [1, 2], "truncate_length": 4},
    "char truncate": {"ngram_range": [1, 2], "analyzer": "char", "truncate_length": 10},
    "df pruning": {"ngram_range": [1, 1], "min_df_cnt": 2, "max_df_ratio": 0.6},
    "max_feature": {"ngram_range": [1, 2], "max_feature": 9},
    "max_feature rare": {"ngram_range": [1, 2], "max_feature": 9, "keep_frequent_feature": False},
    "sublinear l1": {"ngram_range": [1, 1], "sublinear_tf": True, "norm": "l1", "smooth_idf": False, "add_one_idf": True},
    "binary no idf": {"ngram_range": [1, 1], "binary": True, "use_idf": False},
    "ensemble": {
        "base_vect_configs": [{"ngram_range": [1, 2], "analyzer": "word"}, {"ngram_range": [3, 3], "analyzer": "char", "norm": "l1"}],
        "norm": "l2",
    },
}


def _assert_csr_equal(got, want):
    got, want = got.tocsr(), want.tocsr()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tfidf_matches_jax_and_plain(name):
    cfg = CONFIGS[name]
    ours, theirs = Tfidf.train(CORPUS, dict(cfg)), JTfidf.train(CORPUS, dict(cfg))
    assert [b.vocab for b in ours.bases] == [b.vocab for b in theirs.bases]
    for a, b in zip(ours.bases, theirs.bases):
        np.testing.assert_array_equal(a.idf, b.idf)
    queries = CORPUS + ["unseen words only", "the fox—and «the» dog"]
    X = ours.predict(queries)
    _assert_csr_equal(X, theirs.predict(queries))
    # the plain Python version: the same vocabulary and the same matrix
    plain = Tfidf.train_plain(CORPUS + EMPTY, dict(cfg))
    assert [b.vocab for b in plain.bases] == [b.vocab for b in Tfidf.train(CORPUS + EMPTY, dict(cfg)).bases]
    queries = EMPTY + queries + EMPTY
    X = ours.predict(queries)
    _assert_csr_equal(ours.predict_plain(queries), X)
    assert X[[0, 2, len(queries) - 5, len(queries) - 3]].nnz == 0


def test_non_ascii_punctuation_is_a_word_byte():
    """The native rule: non-ASCII punctuation joins the words around it, where
    Python's \\w would split; lower-casing runs before tokenizing."""
    model = Tfidf.train(["Em—Dash «Quote» Wait…", "em dash"], {"ngram_range": [1, 1]})
    assert sorted(model.bases[0].vocab) == ["dash", "em", "em—dash", "wait…", "«quote»"]
    assert vectorizers._tokenize("Em—Dash «Quote» Wait…", "word", -1) == ["em—dash", "«quote»", "wait…"]


def test_save_load_both_ways(tmp_path):
    cfg = {"type": "tfidf", "kwargs": CONFIGS["ensemble"]}
    ours, theirs = Vectorizer.train(CORPUS, cfg), JVectorizer.train(CORPUS, cfg)
    ours.save(str(tmp_path / "torch"))
    theirs.save(str(tmp_path / "jax"))
    X = ours.predict(CORPUS)
    for loaded in (Vectorizer.load(str(tmp_path / "jax")), Vectorizer.load(str(tmp_path / "torch"))):
        _assert_csr_equal(loaded.predict(CORPUS), X)
    _assert_csr_equal(JVectorizer.load(str(tmp_path / "torch")).predict(CORPUS), X)
    with pytest.raises(ValueError, match="unknown vectorizer type"):
        Vectorizer.train(CORPUS, {"type": "nope"})


@pytest.mark.parametrize("max_feature", [0, 400])
def test_streaming_train_file(tmp_path, max_feature):
    rng = np.random.default_rng(0)
    pool = [f"tok{i}" for i in range(300)] + ["naïve", "café—bar"]
    corpus = [" ".join(rng.choice(pool, size=rng.integers(3, 20))) for _ in range(500)]
    path = tmp_path / "corpus.txt"
    path.write_text("\n".join(corpus) + "\n", encoding="utf-8")
    cfg = {"ngram_range": [1, 2], "max_feature": max_feature}
    in_mem = Tfidf.train(corpus, dict(cfg))
    streamed = Tfidf.train(str(path), {**cfg, "chunk_docs": 64})  # 8 chunks
    theirs = JTfidf.train(str(path), {**cfg, "chunk_docs": 64})
    assert streamed.bases[0].vocab == in_mem.bases[0].vocab == theirs.bases[0].vocab
    np.testing.assert_array_equal(streamed.bases[0].idf, in_mem.bases[0].idf)
    _assert_csr_equal(streamed.predict(corpus), in_mem.predict(corpus))
    _assert_csr_equal(streamed.predict(str(path)), theirs.predict(corpus))


def test_streaming_hash_collision_restarts_in_memory(tmp_path, monkeypatch):
    """A chunk whose unique hashes outnumber its strings (two n-grams on one
    64-bit hash) makes train_file restart with the in-memory train."""
    path = tmp_path / "corpus.txt"
    path.write_text("a b c\nb c d\n", encoding="utf-8")
    real = vectorizers._native_count

    def colliding(corpus, *args, **kwargs):
        out = real(corpus, *args, **kwargs)
        if len(corpus) == 1:  # the chunks of train_file, not the restart's whole file
            doc_indptr, hashes, counts, (blob, soffs, shash, sdfs) = out
            return doc_indptr, hashes, counts, (blob, soffs[:-1], shash[:-1], sdfs[:-1])
        return out

    monkeypatch.setattr(vectorizers, "_native_count", colliding)
    streamed = Tfidf.train(str(path), {"chunk_docs": 1})
    assert streamed.bases[0].vocab == {"a": 0, "b": 1, "c": 2, "d": 3}


def test_pickle_drops_the_native_handle():
    model = Tfidf.train(CORPUS, CONFIGS["word"])
    X = model.predict(CORPUS)  # builds the native lookup table
    assert getattr(model.bases[0], "_lookup", None) is not None
    again = pickle.loads(pickle.dumps(model))
    assert getattr(again.bases[0], "_lookup", None) is None
    _assert_csr_equal(again.predict(CORPUS), X)


def test_sklearn_vectorizers_train_and_round_trip(tmp_path):
    for ty, kwargs in (("sklearn_tfidf", {"ngram_range": [1, 2]}), ("sklearn_hashing", {"n_features": 64})):
        v = Vectorizer.train(CORPUS, {"type": ty, "kwargs": kwargs})
        X = v.predict(CORPUS)
        assert X.dtype == np.float32 and X.shape[0] == len(CORPUS)
        v.save(str(tmp_path / ty))
        assert (Vectorizer.load(str(tmp_path / ty)).predict(CORPUS) != X).nnz == 0


def test_preprocessor_file_parser(tmp_path):
    path = tmp_path / "data.txt"
    path.write_text("0,2\tthe quick brown fox\n1\tlazy dog sleeps\n\t no labels here\n\n3, 1\tsecond\tthird field\n")
    items = tmp_path / "items.txt"
    items.write_text("\n".join(f"item{i}" for i in range(6)) + "\n")
    for kw in ({}, {"label_text_path": str(items)}, {"text_pos": 2}):
        got, want = Preprocessor.load_data_from_file(str(path), **kw), JPreprocessor.load_data_from_file(str(path), **kw)
        assert got["corpus"] == want["corpus"]
        _assert_csr_equal(got["label_matrix"], want["label_matrix"])
    assert Preprocessor.load_data_from_file(str(path), label_text_path=str(items))["label_matrix"].shape == (5, 6)


def test_preprocessor_cli(tmp_path):
    """build and run through the port's CLI, the JAX package's Preprocessor on
    the same files, equal outputs; and the port's folder loads in JAX."""
    data = tmp_path / "train.txt"
    data.write_text("\n".join(f"{i % 3}\t{doc}" for i, doc in enumerate(CORPUS)) + "\n", encoding="utf-8")
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"type": "tfidf", "kwargs": CONFIGS["ensemble"]}))
    model, X_path, Y_path = tmp_path / "pre", tmp_path / "X.npz", tmp_path / "Y.npz"
    cli = [sys.executable, "-m", "pecos_tpu_torch.utils.featurization.text.preprocess"]
    for args in (
        ["build", "-i", str(data), "-m", str(model), "--vectorizer-config-path", str(cfg), "--from-xmc-file"],
        ["run", "-i", str(data), "-m", str(model), "-x", str(X_path), "-y", str(Y_path), "--from-xmc-file"],
    ):
        proc = subprocess.run(cli + args, cwd=REPO, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
    parsed = JPreprocessor.load_data_from_file(str(data))
    jpre = JPreprocessor.train(parsed["corpus"], vectorizer_config=json.loads(cfg.read_text()))
    _assert_csr_equal(smat_util.load_matrix(str(X_path)), jpre.predict(parsed["corpus"]))
    _assert_csr_equal(smat_util.load_matrix(str(Y_path)), parsed["label_matrix"])
    _assert_csr_equal(JPreprocessor.load(str(model)).predict(parsed["corpus"]), jpre.predict(parsed["corpus"]))


def test_sentencepiece_missing_raises_import_error():
    pytest.importorskip("pecos_tpu_torch.utils.featurization.text.sentencepiece_util")
    try:
        import sentencepiece  # noqa: F401

        pytest.skip("sentencepiece is installed")
    except ImportError:
        pass
    from pecos_tpu_torch.utils.featurization.text.sentencepiece_util import SentencePieceVectorizer

    assert Vectorizer.vectorizer_dict["sentencepiece"] is SentencePieceVectorizer
    with pytest.raises(ImportError, match="pip install sentencepiece"):
        Vectorizer.train(CORPUS, {"type": "sentencepiece", "kwargs": {"vocab_size": 20}})
    with pytest.raises(ImportError, match="pip install sentencepiece"):
        SentencePieceVectorizer(b"", 20, False).predict(CORPUS)
