"""The port's XR-Transformer predict against the benchmark's plain reference
(``portbench/models/xtransformer_reference.py``: float64 PyTorch, no
``transformers``, no ``tokenizers``, nothing of the port) on seeded random
weights, at a tiny BERT: the pooled embeddings of ``encode_batches``, the
token ids of ``wordpiece_tokenizer``, and ``XTransformer.predict``
(concat-only) through the benchmark's XR-Transformer kind on a tiny tree.
Also the pipelined encoder, which tokenizes a block at a time, against the
whole corpus's arrays: bit-equal embeddings, counters and predictions."""

import os
import tempfile

import numpy as np
import pytest
import torch

from pecos_tpu_torch.utils import profile_util
from pecos_tpu_torch.xmc.xtransformer import TransformerMatcher, network
from pecos_tpu_torch.xmc.xtransformer.module import CorpusTokens, tokenize_corpus
from portbench.models import xtransformer, xtransformer_reference

CPU = torch.device("cpu")
TINY_BERT = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128, vocab_size=300,
                 max_position_embeddings=32, type_vocab_size=2, layer_norm_eps=1e-12, hidden_act="gelu",
                 initializer_range=0.02, pad_token_id=0)
LENGTH = 16
WORDS = {"law": "lognormal", "median": 10, "sigma": 1.0, "min": 1, "max": 40}
# a tree of 2, 8, 32 nodes and 600 labels; the matcher's head over the 32 leaf clusters
RANKER = {
    "nr_labels": 600, "nr_features": 5000, "mean_query_nnz": 20, "nr_splits": 4, "max_leaf_size": 20,
    "weights_per_label": 16, "bias": 1.0, "beam_size": 4, "only_topk": 10, "post_processor": "l3-hinge",
    "zipf_s": 1.0, "weight_std": 0.25, "bias_weight_std": 0.05, "compare_sample": 64,
    "topic": {"features": 16, "node_slots": 8, "label_slots": 4, "query_share": 0.25, "weight_mean": 0.5,
              "weight_std": 0.25},
}
CONFIG = dict(RANKER, model="xtransformer", encoder_type="bert", model_config=TINY_BERT, truncate_length=LENGTH,
              encoder_batch=256, max_match_clusters=32)
# float32 against float64 through two layers of width 64: each pooled value
# (in (-1, 1)) is within a few float32 ulps of 1; 1e-5 leaves room for the
# sums' order and stays far below what bfloat16 (~4e-3) or a wrong layer gives
POOLED_ATOL = 1e-5
# a served score is the product of four levels' float32 values; relative 2e-5
# is ~170 float32 ulps
VALUE_RTOL = 2e-5


@pytest.fixture(scope="module")
def vocab():
    return xtransformer.vocabulary(TINY_BERT["vocab_size"], 11)


@pytest.fixture(scope="module")
def tokenizer(vocab):
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "vocab.txt")
        with open(path, "w") as f:
            f.write("\n".join(vocab) + "\n")
        return network.wordpiece_tokenizer(path)


@pytest.fixture(scope="module")
def texts(vocab):
    return xtransformer.make_texts(vocab, xtransformer.word_counts(96, WORDS, 5), 6)


def test_reference_tokens_equal_wordpiece(vocab, tokenizer, texts):
    assert any(len(t.split()) > LENGTH - 2 for t in texts) and any(len(t.split()) < LENGTH - 2 for t in texts)
    got = tokenize_corpus(tokenizer, texts, LENGTH)
    ids, mask = xtransformer_reference.tokens(vocab, texts, LENGTH)
    np.testing.assert_array_equal(got["input_ids"], ids)
    np.testing.assert_array_equal(got["attention_mask"], mask)


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_encode_batches_matches_the_reference(vocab, tokenizer, texts, seed):
    encoder = network.random_encoder("bert", TINY_BERT, seed=seed)
    toks = tokenize_corpus(tokenizer, texts, LENGTH)
    got = network.encode_batches(encoder, toks, CPU, batch_size=32).numpy()
    ref = xtransformer_reference.Encoder(encoder.state_dict(), TINY_BERT, CPU)
    ids, mask = xtransformer_reference.tokens(vocab, texts, LENGTH)
    want = ref.pooled(ids, mask).numpy()
    assert got.dtype == np.float32 and want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=POOLED_ATOL)
    assert np.abs(want[1:] - want[:1]).max() > 100 * POOLED_ATOL  # texts differ by far more than the tolerance


def test_xtransformer_predict_matches_the_reference():
    model = xtransformer.Model(CONFIG, 2**31 + 9, CPU)
    lengths = np.random.default_rng(0).integers(4, 60, 96)
    Q = xtransformer.queries(model, 96, lengths, {"text_words": WORDS}, 2**31 + 9, CPU)
    P = xtransformer.Program(model, CPU).predict(Q).tocsr()
    ref = xtransformer_reference.build(model, CONFIG, CPU)
    out = ref.beam_search(Q)
    k = CONFIG["only_topk"]
    assert P.shape == (96, RANKER["nr_labels"]) and (np.diff(P.indptr) == k).all()
    labels = np.stack([P.indices[P.indptr[r] : P.indptr[r + 1]] for r in range(96)]).astype(np.int64)
    values = np.stack([P.data[P.indptr[r] : P.indptr[r + 1]] for r in range(96)])
    true = ref.path_values(Q, labels)
    np.testing.assert_allclose(values, true, rtol=VALUE_RTOL)
    clear = out["margin"] >= 2 * VALUE_RTOL
    assert clear.sum() >= 80
    for r in np.nonzero(clear)[0]:
        assert set(labels[r]) == set(out["labels"][r]), r


# ---- the pipelined path (a CorpusTokens, tokenized a block at a time) against the whole corpus's arrays ----

ENCODE_COUNTERS = ("pecos.encode.texts", "pecos.encode.tokens", "pecos.encode.slots")


def encode_with_counters(encoder, toks, batch_size):
    profile_util.reset()
    emb = network.encode_batches(encoder, toks, CPU, batch_size=batch_size).numpy()
    counters = profile_util.snapshot()["counters"]
    profile_util.reset()
    return emb, {k: counters.get(k, 0) for k in ENCODE_COUNTERS}


@pytest.mark.parametrize("n", [0, 1, 6, 7, 8, 17])
def test_blockwise_tokenizing_encodes_bit_equal_to_the_whole_corpus(tokenizer, texts, n):
    """Batches of 7: corpora of 0, 1, 7 - 1, 7, 7 + 1 and 2 x 7 + 3 texts,
    among them texts longer than the truncate length."""
    corpus = sorted(texts, key=lambda t: -len(t.split()))[:n]  # the longest first
    assert n == 0 or len(corpus[0].split()) > LENGTH - 2
    encoder = network.random_encoder("bert", TINY_BERT, seed=3)
    # the tokenizer refuses an empty list: no texts are arrays of no rows
    whole = (tokenize_corpus(tokenizer, corpus, LENGTH) if n
             else {k: np.zeros((0, LENGTH), np.int32) for k in ("input_ids", "attention_mask")})
    want, want_counts = encode_with_counters(encoder, whole, 7)
    got, got_counts = encode_with_counters(encoder, CorpusTokens(tokenizer, corpus, LENGTH), 7)
    assert got.shape == want.shape == (n, TINY_BERT["hidden_size"])
    np.testing.assert_array_equal(got, want)
    assert got_counts == want_counts


@pytest.fixture(scope="module")
def pipeline_program():
    """The benchmark kind's tiny program and 515 queries: encoder blocks of
    256, 256 and 3 texts."""
    model = xtransformer.Model(CONFIG, 2**31 + 13, CPU)
    lengths = np.random.default_rng(1).integers(4, 60, 515)
    Q = xtransformer.queries(model, 515, lengths, {"text_words": WORDS}, 2**31 + 13, CPU)
    return xtransformer.Program(model, CPU), Q


def assert_csr_equal(a, b):
    a, b = a.tocsr(), b.tocsr()
    assert a.shape == b.shape
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_xtransformer_predict_equals_the_whole_corpus_path(pipeline_program):
    prog, Q = pipeline_program
    xtf = prog.xtf
    matcher = xtf.text_encoder
    whole = tokenize_corpus(matcher.tokenizer, Q.texts, matcher.pred_params.truncate_length)
    want = xtf.concat_model.predict(TransformerMatcher.concat_features(Q.X, matcher._embed(whole)),
                                    **{k: v for k, v in prog.kw.items() if k != "ens_method"})
    assert_csr_equal(prog.predict(Q), want)
    np.testing.assert_array_equal(xtf.encode(Q.texts), matcher._embed(whole))


def test_matcher_predict_equals_the_whole_corpus_path(pipeline_program):
    prog, Q = pipeline_program
    matcher = prog.xtf.text_encoder
    pred_params = matcher.get_pred_params()
    whole = tokenize_corpus(matcher.tokenizer, Q.texts, pred_params.truncate_length)
    want_P, want_emb = matcher._predict_tokens(whole, None, pred_params)
    got_P, got_emb = matcher.predict(Q.texts)
    assert_csr_equal(got_P, want_P)
    np.testing.assert_array_equal(got_emb, want_emb)
