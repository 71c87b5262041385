"""XR-Transformer in the port against the JAX package, on the CPU at tiny
widths (DistilBERT dim 32, one layer, as tests/test_xtransformer.py).

- module: build_active_label_batches and tokenize_corpus (and its npz cache)
  give the JAX package's arrays exactly.
- network: every encoder family loaded through encoder_state_from_flax from
  the JAX package's random-init Flax params gives its pooled embedding within
  atol 2e-4 / rtol 2e-3 (tests/test_flax_xlnet.py's tolerance), and the
  state dict equals transformers' own Flax loader's; flax_model.msgpack read
  by the port's reader equals flax's (chunked leaves too); head_logits,
  squared_hinge_loss and the head bootstraps equal.
- matcher: three optimizer steps (dropout 0, lr 1e-3), with and without
  gradient accumulation: each micro-step's loss within rtol 1e-5 and every
  weight within atol 1e-5 of the JAX package's (the steps move weights by
  ~1.5e-3); the first step moves nothing; predict with a csr_codes prior
  gives the JAX package's labels (ties at -1e30 aside); the port's own train
  meets tests/test_xtransformer.py's bars.
- XTransformer: a JAX-saved folder predicted by the port, and a port-saved
  folder by the JAX package, with the same labels for every ens_method.
- the three CLIs with --device cpu; every entry point raises without a GPU.
"""

import json
import os

import numpy as np
import pytest
import scipy.sparse as smat
import torch

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

from pecos_tpu_torch.xmc.xtransformer import MLProblemWithText, TransformerMatcher, XTransformer, network  # noqa: E402
from pecos_tpu_torch.xmc.xtransformer import module as tmodule  # noqa: E402

ENC_ATOL, ENC_RTOL = 2e-4, 2e-3
STEP_LOSS_RTOL, STEP_PARAM_ATOL = 1e-5, 1e-5
ENS_METHODS = ("concat-only", "transformer-only", "average", "rank_average", "sigmoid_average", "softmax_average", "round_robin")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """tests/test_xtransformer.py's toy: 64 texts of 3 words, 8 labels."""
    d = tmp_path_factory.mktemp("txtf")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"tok{i}" for i in range(24)]
    vocab_file = d / "vocab.txt"
    vocab_file.write_text("\n".join(vocab) + "\n")
    corpus = [f"tok{i % 8} tok{i % 8 + 8} tok{i % 8 + 16}" for i in range(64)]
    Y = smat.csr_matrix((np.ones(64, np.float32), (np.arange(64), np.arange(64) % 8)), shape=(64, 8))
    X_feat = smat.csr_matrix(np.random.default_rng(0).standard_normal((64, 12)).astype(np.float32))
    model_config = dict(vocab_size=len(vocab), dim=32, n_layers=1, n_heads=2, hidden_dim=64,
                        max_position_embeddings=64, vocab_file=str(vocab_file))
    return dict(dir=d, corpus=corpus, Y=Y, X_feat=X_feat, model_config=model_config, vocab_file=str(vocab_file))


def _train_params(model_config, epochs=8, **kw):
    return dict(model_type="distilbert", model_config=model_config, truncate_length=16, batch_size=16,
                num_train_epochs=epochs, learning_rate=2e-3, max_active_matching_labels=8,
                bootstrap_method="inherit", seed=0, **kw)


def _acc(P, Y):
    return (np.asarray(P.argmax(axis=1)).ravel() == np.asarray(Y.argmax(axis=1)).ravel()).mean()


# ---------------------------------------------------------------------------
# module
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["matched", "all_negatives", "relevance"])
def test_active_label_batches_equal_jax(case):
    from pecos_tpu.xmc.xtransformer.module import build_active_label_batches as jax_build

    rng = np.random.default_rng(5)
    N, L = 40, 30
    Y = smat.random(N, L, density=0.08, format="csr", random_state=1, dtype=np.float32)
    Y[3] = 0
    Y[4, :20] = 1.0  # more positives than max_active: subsampled
    Y = smat.csr_matrix(Y)
    M = smat.csr_matrix((rng.random((N, L)) < 0.4).astype(np.float32)) if case != "all_negatives" else None
    R = smat.csr_matrix(Y.multiply(rng.random((N, L)).astype(np.float32))) if case == "relevance" else None
    args = dict(max_active=12, pad_label=L, Cp=2.0, Cn=0.5)
    got = tmodule.build_active_label_batches(Y, M, R, rng=np.random.default_rng(7), **args)
    want = jax_build(Y, M, R, rng=np.random.default_rng(7), **args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_tokenize_corpus_equal_jax(tiny, tmp_path):
    from transformers import DistilBertTokenizerFast

    from pecos_tpu.xmc.xtransformer.module import tokenize_corpus as jax_tokenize

    texts = tiny["corpus"][:10] + ["Tok3 unknown tok5tok6", "", "tok1 " * 40]
    jtok = DistilBertTokenizerFast(vocab_file=tiny["vocab_file"])
    want = jax_tokenize(jtok, texts, 16)
    # the port's WordPiece tokenizer (the one transformers 5 can build) gives the same ids
    got = tmodule.tokenize_corpus(network.wordpiece_tokenizer(tiny["vocab_file"]), texts, 16)
    for k in ("input_ids", "attention_mask"):
        assert got[k].dtype == np.int32 and got[k].shape == (len(texts), 16)
        np.testing.assert_array_equal(got[k], want[k])
    # the npz cache: one key, so a file the JAX package wrote is read back here
    jax_tokenize(jtok, texts, 16, cache_dir=str(tmp_path))
    files = os.listdir(tmp_path)
    assert len(files) == 1
    assert tmodule._cache_path(jtok, texts, 16, str(tmp_path)) == str(tmp_path / files[0])
    np.savez(tmp_path / files[0], input_ids=want["input_ids"] + 1, attention_mask=want["attention_mask"])
    np.testing.assert_array_equal(tmodule.tokenize_corpus(jtok, texts, 16, cache_dir=str(tmp_path))["input_ids"], want["input_ids"] + 1)


def test_text_dataset_shards_roundtrip_jax(tiny, tmp_path):
    from pecos_tpu.xmc.xtransformer.module import XMCTextDataset as JaxDataset

    tok = network.wordpiece_tokenizer(tiny["vocab_file"])
    Y = tiny["Y"]
    M = (Y @ smat.csr_matrix(np.ones((8, 4), np.float32))).tocsr()
    ds = tmodule.XMCTextDataset.from_text(tok, tiny["corpus"], truncate_length=16, Y=Y, M=M)
    ds.save(str(tmp_path / "port"), num_shards=4)
    back = JaxDataset.load(str(tmp_path / "port"), shard=2)  # the JAX package reads the port's shards
    np.testing.assert_array_equal(back.tokens["input_ids"], ds.tokens["input_ids"][32:48])
    assert (back.M != M[32:48]).nnz == 0 and back.R is None
    JaxDataset(ds.tokens, Y=Y).save(str(tmp_path / "jax"), num_shards=2)
    s1 = tmodule.XMCTextDataset.load(str(tmp_path / "jax"), shard=1)
    assert len(s1) == 32 and (s1.Y != Y[32:]).nnz == 0 and s1.M is None
    ids, tgt, cost = s1.label_batches(max_active=8, pad_label=8, rng=np.random.default_rng(0))
    assert ids.shape == (32, 8) and (cost[:, 0] == 1.0).all()
    with pytest.raises(ValueError):
        tmodule.XMCTextDataset.load(str(tmp_path / "jax"), shard=5)


# ---------------------------------------------------------------------------
# network
# ---------------------------------------------------------------------------

_FAMILY_CONFIGS = {
    "bert": dict(vocab_size=53, hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
                 max_position_embeddings=64),
    "roberta": dict(vocab_size=53, hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
                    max_position_embeddings=64),
    "distilbert": dict(vocab_size=53, dim=32, n_layers=2, n_heads=2, hidden_dim=64, max_position_embeddings=64),
    "xlm-roberta": dict(vocab_size=53, hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
                        max_position_embeddings=64),
    "xlnet": dict(vocab_size=53, d_model=32, n_layer=2, n_head=2, d_inner=64, ff_activation="gelu"),
}


def _jax_encoder(model_type, seed=0):
    from pecos_tpu.xmc.xtransformer import network as jnet

    config_cls, model_cls, _ = jnet.resolve_encoder(model_type)
    return model_cls(config_cls(**_FAMILY_CONFIGS[model_type]), seed=seed)


def _ids_and_mask(seed, pad_id):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 53, size=(3, 12)).astype(np.int32)
    am = np.ones((3, 12), np.int32)
    am[1, 9:] = 0
    am[2, 5:] = 0
    ids[am == 0] = pad_id
    return ids, am


@pytest.mark.parametrize("model_type", sorted(_FAMILY_CONFIGS))
def test_encoder_from_flax_params_matches_jax(model_type):
    from pecos_tpu.xmc.xtransformer import network as jnet

    fx = _jax_encoder(model_type)
    pt = network.resolve_encoder(model_type)[1](network.resolve_encoder(model_type)[0](**_FAMILY_CONFIGS[model_type])).eval()
    state = network.encoder_state_from_flax(fx.params, model_type)
    network.load_state_strict(pt, state)
    ids, am = _ids_and_mask(3, getattr(pt.config, "pad_token_id", 0) or 0)
    want = np.asarray(jnet.pooled_embedding(fx(input_ids=ids, attention_mask=am), am))
    with torch.no_grad():
        mm = torch.from_numpy(am.astype(np.int64))
        got = network.pooled_embedding(pt(input_ids=torch.from_numpy(ids.astype(np.int64)), attention_mask=mm), mm).numpy()
    assert got.shape == want.shape == (3, 32)
    np.testing.assert_allclose(got, want, atol=ENC_ATOL, rtol=ENC_RTOL)
    try:  # transformers 4.x's own converter, where it exists, gives the same state dict
        from transformers.modeling_flax_pytorch_utils import load_flax_weights_in_pytorch_model
    except ImportError:
        return
    ref = load_flax_weights_in_pytorch_model(type(pt)(pt.config), fx.params).state_dict()
    for k, v in state.items():
        assert torch.equal(ref[k], v), k


def test_flax_msgpack_reader(tmp_path, monkeypatch):
    import flax.serialization as fser
    import jax

    fx = _jax_encoder("distilbert", seed=1)
    fx.save_pretrained(tmp_path / "enc")
    with open(tmp_path / "enc" / "flax_model.msgpack", "rb") as f:
        want = fser.msgpack_restore(f.read())
    got = network.read_flax_msgpack(str(tmp_path / "enc" / "flax_model.msgpack"))
    wl, gl = jax.tree_util.tree_leaves_with_path(want), jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in wl] == [p for p, _ in gl]
    for (_, w), (_, g) in zip(wl, gl):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    # leaves above flax's chunk size are written as chunks, and joined again here
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 256)
    tree = {"a": {"kernel": np.arange(300, dtype=np.float32).reshape(20, 15)}, "s": np.float32(2.5), "n": np.arange(3)}
    (tmp_path / "chunked.msgpack").write_bytes(fser.msgpack_serialize(tree))
    back = network.read_flax_msgpack(str(tmp_path / "chunked.msgpack"))
    np.testing.assert_array_equal(back["a"]["kernel"], tree["a"]["kernel"])
    assert back["s"] == 2.5 and back["n"].tolist() == [0, 1, 2]
    # the JAX package's encoder folder loads as a torch model with its weights
    pt = network.load_encoder(str(tmp_path / "enc"), "distilbert")
    st = network.encoder_state_from_flax(fx.params, "distilbert")
    assert all(torch.equal(pt.state_dict()[k], v) for k, v in st.items())


def test_head_loss_and_bootstraps_equal_jax():
    import jax.numpy as jnp

    from pecos_tpu.xmc.xtransformer import network as jnet

    rng = np.random.default_rng(2)
    W = rng.standard_normal((11, 6)).astype(np.float32)
    b = rng.standard_normal(11).astype(np.float32)
    emb = rng.standard_normal((4, 6)).astype(np.float32)
    ids = rng.integers(0, 11, size=(4, 5))
    tgt = np.where(rng.random((4, 5)) < 0.4, 1.0, -1.0).astype(np.float32)
    cost = np.where(rng.random((4, 5)) < 0.8, rng.random((4, 5)), 0.0).astype(np.float32)
    want = np.asarray(jnet.head_logits(jnp.asarray(W), jnp.asarray(b), jnp.asarray(emb), jnp.asarray(ids)))
    got = network.head_logits(*(torch.from_numpy(a) for a in (W, b, emb, ids))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    lw = float(jnet.squared_hinge_loss(jnp.asarray(want), jnp.asarray(tgt), jnp.asarray(cost)))
    lg = float(network.squared_hinge_loss(torch.from_numpy(got), torch.from_numpy(tgt), torch.from_numpy(cost)))
    assert lg == pytest.approx(lw, rel=1e-6)
    C = smat.csc_matrix((np.ones(10, np.float32), (np.arange(10), np.arange(10) % 3)), shape=(10, 3))
    parent_j, parent_t = jnet.XMCHead.random(3, 6, seed=4), network.XMCHead.random(3, 6, seed=4)
    np.testing.assert_array_equal(parent_t.W, parent_j.W)
    for got_h, want_h in ((network.XMCHead.inherit(parent_t, C), jnet.XMCHead.inherit(parent_j, C)),
                          (network.XMCHead.from_linear(np.vstack([W[:6].T, b[:10][None, :6]])),
                           jnet.XMCHead.from_linear(np.vstack([W[:6].T, b[:10][None, :6]])))):
        np.testing.assert_array_equal(got_h.W, want_h.W)
        np.testing.assert_array_equal(got_h.b, want_h.b)


# ---------------------------------------------------------------------------
# matcher
# ---------------------------------------------------------------------------


class _StepSpy:
    """Stands in for the JAX matcher module's ``jax``: records the loss each
    jitted train_step returns, and is jax for everything else."""

    def __init__(self, jax):
        self._jax, self.losses = jax, []

    def __getattr__(self, name):
        return getattr(self._jax, name)

    def jit(self, fn, **kw):
        f = self._jax.jit(fn, **kw)
        if fn.__name__ != "train_step":
            return f

        def step(*args):
            out = f(*args)
            self.losses.append(float(out[2]))
            return out

        return step


@pytest.fixture(scope="module")
def init_folder(tiny):
    """The JAX package's random-init encoder (dropout 0) and tokenizer, saved:
    both packages start from these weights."""
    from pecos_tpu.xmc.xtransformer import TransformerMatcher as JaxMatcher

    mc = dict(tiny["model_config"], dropout=0.0, attention_dropout=0.0)
    enc, tok = JaxMatcher.download_model(JaxMatcher.TrainParams(model_type="distilbert", model_config=mc, seed=0))
    folder = str(tiny["dir"] / "init_encoder")
    enc.save_pretrained(folder)
    tok.save_pretrained(folder)
    return folder, enc


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_jax(tiny, init_folder, monkeypatch, accum):
    import jax

    import pecos_tpu.xmc.xtransformer.matcher as jax_matcher_mod
    from pecos_tpu.xmc.xtransformer import MLProblemWithText as JaxProb, TransformerMatcher as JaxMatcher

    folder, init = init_folder
    kw = dict(model_type="distilbert", model_shortcut=folder, truncate_length=16, batch_size=16, max_steps=3,
              num_train_epochs=2, learning_rate=1e-3, max_active_matching_labels=8, gradient_accumulation_steps=accum, seed=0)
    spy = _StepSpy(jax)
    monkeypatch.setattr(jax_matcher_mod, "jax", spy)
    want, _, _ = JaxMatcher.train(JaxProb(tiny["corpus"], tiny["Y"]), train_params=JaxMatcher.TrainParams(**kw))
    monkeypatch.undo()
    got, _, _ = TransformerMatcher.train(MLProblemWithText(tiny["corpus"], tiny["Y"]), train_params=kw, device="cpu")
    assert len(spy.losses) == 3 * accum
    np.testing.assert_allclose(got.train_losses, spy.losses, rtol=STEP_LOSS_RTOL)
    w_state = network.encoder_state_from_flax(want.encoder.params, "distilbert")
    g_state = got.encoder.state_dict()
    i_state = network.encoder_state_from_flax(init.params, "distilbert")
    moved = max(float((g_state[k] - i_state[k]).abs().max()) for k in w_state)
    assert moved > 100 * STEP_PARAM_ATOL
    for k, v in w_state.items():
        np.testing.assert_allclose(g_state[k].numpy(), v.numpy(), atol=STEP_PARAM_ATOL, err_msg=k)
    np.testing.assert_allclose(got.head.W, want.head.W, atol=STEP_PARAM_ATOL)
    np.testing.assert_allclose(got.head.b, want.head.b, atol=STEP_PARAM_ATOL)


def test_first_step_leaves_weights_unmoved(tiny, init_folder):
    """The schedule's rate is 0.0 at the first optimizer step: AdamW's
    moments move, the weights stay bit-equal (weight decay included)."""
    folder, init = init_folder
    kw = dict(model_type="distilbert", model_shortcut=folder, truncate_length=16, batch_size=16, max_steps=1,
              learning_rate=1e-3, max_active_matching_labels=8, seed=0)
    got, _, _ = TransformerMatcher.train(MLProblemWithText(tiny["corpus"], tiny["Y"]), train_params=kw, device="cpu")
    i_state = network.encoder_state_from_flax(init.params, "distilbert")
    assert all(torch.equal(got.encoder.state_dict()[k], v) for k, v in i_state.items())
    np.testing.assert_array_equal(got.head.W, network.XMCHead.random(8, 32, seed=0).W)


def test_schedule_and_clip_match_optax():
    import jax.numpy as jnp
    import optax

    from pecos_tpu_torch.xmc.xtransformer.matcher import clip_by_global_norm_, lr_lambda

    for total, warm in ((10, 0), (10, 3), (4, 6)):
        w = max(warm, 1)
        sched = optax.join_schedules([optax.linear_schedule(0.0, 1.0, w), optax.linear_schedule(1.0, 0.0, max(total - w, 1))], [w])
        f = lr_lambda(total, warm)
        assert [f(s) for s in range(total + 3)] == pytest.approx([float(sched(s)) for s in range(total + 3)], abs=1e-7)
    rng = np.random.default_rng(0)
    for scale in (0.1, 10.0):
        gs = [rng.standard_normal(s).astype(np.float32) * scale for s in ((3, 4), (5,))]
        want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in gs], None)
        got = [torch.from_numpy(g.copy()) for g in gs]
        clip_by_global_norm_(got, 1.0)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_predict_with_prior_matches_jax(tiny, init_folder, tmp_path):
    """A level with C and a csr_codes prior, the JAX package's matcher saved
    and predicted by the port on the CPU: the active labels, their order and
    values equal; where a row has fewer than k active labels the rest enter
    at -1e30, and which of those ties fill the row is unspecified."""
    from pecos_tpu.xmc.xtransformer import MLProblemWithText as JaxProb, TransformerMatcher as JaxMatcher

    folder, _ = init_folder
    C = smat.csc_matrix((np.ones(8, np.float32), (np.arange(8), np.arange(8) // 2)), shape=(8, 4))
    kw = dict(model_type="distilbert", model_shortcut=folder, truncate_length=16, batch_size=16, max_steps=4,
              learning_rate=1e-3, max_active_matching_labels=8, seed=0)
    jm, _, _ = JaxMatcher.train(JaxProb(tiny["corpus"], tiny["Y"]), C=C, train_params=JaxMatcher.TrainParams(**kw))
    jm.save(str(tmp_path / "m"))
    tm = TransformerMatcher.load(str(tmp_path / "m"), device="cpu")
    rng = np.random.default_rng(3)
    prior = smat.csr_matrix(np.where(rng.random((64, 4)) < 0.5, rng.random((64, 4)) + 0.1, 0.0).astype(np.float32))
    for pp, k in (("noop", 3), ("l3-hinge", 5)):
        want, we = jm.predict(tiny["corpus"], csr_codes=prior, only_topk=k, post_processor=pp)
        got, ge = tm.predict(tiny["corpus"], csr_codes=prior, only_topk=k, post_processor=pp)
        np.testing.assert_allclose(ge, we, atol=ENC_ATOL, rtol=ENC_RTOL)
        assert got.shape == want.shape and np.diff(got.indptr).tolist() == [k] * 64
        for i in range(64):
            gi, gv = got[i].indices[np.argsort(-got[i].data, kind="stable")], np.sort(got[i].data)[::-1]
            wi, wv = want[i].indices[np.argsort(-want[i].data, kind="stable")], np.sort(want[i].data)[::-1]
            live = wv > -1e29
            assert (gv > -1e29).tolist() == live.tolist(), i
            np.testing.assert_array_equal(gi[live], wi[live])
            np.testing.assert_allclose(gv[live], wv[live], rtol=1e-5, atol=1e-6)


def test_port_matcher_quality_and_save_load(tiny, tmp_path):
    """tests/test_xtransformer.py's bars for the port's own train: accuracy
    > 0.8, then save / load equal; with an ensembling concat model and
    checkpoint-best validation, gradient accumulation 2."""
    prob = MLProblemWithText(tiny["corpus"], tiny["Y"], X_feat=tiny["X_feat"])
    matcher, trn_pred, trn_emb = TransformerMatcher.train(prob, train_params=_train_params(tiny["model_config"]), device="cpu")
    assert trn_emb.shape == (64, 32) and trn_pred.shape == (64, 8)
    assert _acc(trn_pred, tiny["Y"]) > 0.8
    tp = _train_params(tiny["model_config"], epochs=4, gradient_accumulation_steps=2, save_steps=4)
    m2, pred2, _ = TransformerMatcher.train(
        prob, train_params=tp, pred_params=TransformerMatcher.PredParams(ensemble_method="average"),
        val_prob=MLProblemWithText(tiny["corpus"][:32], tiny["Y"][:32]), device="cpu",
    )
    assert m2.concat_model is not None and _acc(pred2, tiny["Y"]) > 0.8
    m2.save(str(tmp_path / "m"))
    loaded = TransformerMatcher.load(str(tmp_path / "m"), device="cpu")
    P1, E1 = loaded.predict(tiny["corpus"], X_feat=tiny["X_feat"])
    P2, E2 = m2.predict(tiny["corpus"], X_feat=tiny["X_feat"])
    np.testing.assert_allclose(E1, E2, rtol=1e-5, atol=1e-6)
    assert (P1 != P2).nnz == 0
    # warm start and the linear bootstrap on the parent's embeddings
    m3, _, _ = TransformerMatcher.train(prob, train_params=dict(_train_params(tiny["model_config"], epochs=1),
                                                                init_model_dir=str(tmp_path / "m"), bootstrap_method="linear"),
                                        device="cpu")
    assert m3.hidden_size == 32 and m3.head.W.shape == (9, 32)


# ---------------------------------------------------------------------------
# XTransformer
# ---------------------------------------------------------------------------

_XTF_INDEX = {"max_leaf_size": 2, "nr_splits": 2}


def _same_labels(got, want, what):
    """Equal (row, rank) labels; where scores tie within 1e-5 the order of the
    tied labels is free."""
    assert got.shape == want.shape, what
    for i in range(got.shape[0]):
        gs, ws = got[i], want[i]
        go, wo = np.argsort(-gs.data, kind="stable"), np.argsort(-ws.data, kind="stable")
        np.testing.assert_allclose(gs.data[go], ws.data[wo], rtol=1e-4, atol=1e-5, err_msg=f"{what} row {i}")
        for v in np.unique(np.round(ws.data[wo], 4)):
            assert set(gs.indices[go][np.round(gs.data[go], 4) == v]) == set(ws.indices[wo][np.round(ws.data[wo], 4) == v]), (what, i)


def test_xtransformer_folders_both_ways(tiny, tmp_path):
    from pecos_tpu.xmc.xtransformer import MLProblemWithText as JaxProb, XTransformer as JaxXTF

    tp = dict(matcher_params_chain=_train_params(tiny["model_config"], epochs=2), preliminary_indexer_params=_XTF_INDEX,
              refined_indexer_params=_XTF_INDEX)
    X_feat = tiny["X_feat"]
    jx = JaxXTF.train(JaxProb(tiny["corpus"], tiny["Y"], X_feat=X_feat), train_params=tp, threshold=0.0)
    jx.save(str(tmp_path / "jax"))
    tx = XTransformer.load(str(tmp_path / "jax"), device="cpu")
    px = XTransformer.train(MLProblemWithText(tiny["corpus"], tiny["Y"], X_feat=X_feat), train_params=tp, device="cpu",
                            threshold=0.0)
    px.save(str(tmp_path / "port"))
    jp = JaxXTF.load(str(tmp_path / "port"))
    for ens in ENS_METHODS:
        kw = dict(X_feat=X_feat[:16], ens_method=ens, only_topk=3, beam_size=4)
        _same_labels(tx.predict(tiny["corpus"][:16], **kw), jx.predict(tiny["corpus"][:16], **kw), f"jax folder {ens}")
        _same_labels(jp.predict(tiny["corpus"][:16], **kw), px.predict(tiny["corpus"][:16], **kw), f"port folder {ens}")
    np.testing.assert_allclose(tx.encode(tiny["corpus"][:4]), jx.encode(tiny["corpus"][:4]), atol=ENC_ATOL, rtol=ENC_RTOL)


def test_xtransformer_three_phase_quality(tiny):
    """tests/test_xtransformer.py's bars for the port: the three phases give
    accuracy > 0.8; the frozen encoder > 0.5; only_encoder gives no ranker."""
    prob = MLProblemWithText(tiny["corpus"], tiny["Y"], X_feat=tiny["X_feat"])
    xtf = XTransformer.train(prob, train_params=dict(matcher_params_chain=_train_params(tiny["model_config"]),
                                                     preliminary_indexer_params=_XTF_INDEX, refined_indexer_params=_XTF_INDEX),
                             device="cpu", threshold=0.0)
    P = xtf.predict(tiny["corpus"], X_feat=tiny["X_feat"], only_topk=2)
    assert P.shape == (64, 8) and _acc(P, tiny["Y"]) > 0.8
    assert xtf.encode(tiny["corpus"][:4]).shape == (4, 32)
    frozen = XTransformer.train(prob, train_params=dict(
        do_fine_tune=False, fix_clustering=True, preliminary_indexer_params={"nr_splits": 4, "max_leaf_size": 4},
        matcher_params_chain=dict(model_type="distilbert", model_config=tiny["model_config"], truncate_length=16)), device="cpu")
    assert _acc(frozen.predict(tiny["corpus"], X_feat=tiny["X_feat"], beam_size=4, only_topk=3), tiny["Y"]) > 0.5
    enc_only = XTransformer.train(prob, train_params=dict(only_encoder=True, matcher_params_chain=_train_params(tiny["model_config"], epochs=1),
                                                          preliminary_indexer_params=_XTF_INDEX), device="cpu")
    assert enc_only.concat_model is None and enc_only.predict(tiny["corpus"][:4]).shape == (4, 8)


def test_clis_on_cpu(tiny, tmp_path):
    from pecos_tpu_torch.utils import smat_util
    from pecos_tpu_torch.xmc.xtransformer import encode, predict, train

    (tmp_path / "trn.txt").write_text("\n".join(tiny["corpus"]) + "\n")
    smat_util.save_matrix(str(tmp_path / "Y.npz"), tiny["Y"])
    smat_util.save_matrix(str(tmp_path / "X.npz"), tiny["X_feat"])
    params = {"train_params": XTransformer.TrainParams(
        matcher_params_chain=TransformerMatcher.TrainParams(**_train_params(tiny["model_config"], epochs=4)),
        preliminary_indexer_params=_XTF_INDEX, refined_indexer_params=_XTF_INDEX).to_dict()}
    (tmp_path / "params.json").write_text(json.dumps(params))
    model = str(tmp_path / "model")
    train.main(["-t", str(tmp_path / "trn.txt"), "-x", str(tmp_path / "X.npz"), "-y", str(tmp_path / "Y.npz"), "-m", model,
                "--params-path", str(tmp_path / "params.json"), "--device", "cpu", "--verbose-level", "0"])
    predict.main(["-t", str(tmp_path / "trn.txt"), "-x", str(tmp_path / "X.npz"), "-m", model, "-o", str(tmp_path / "P.npz"),
                  "-k", "3", "--device", "cpu"])
    P = smat_util.load_matrix(str(tmp_path / "P.npz"))
    assert P.shape == (64, 8) and P.nnz == 64 * 3 and _acc(P.tocsr(), tiny["Y"]) > 0.8
    encode.main(["-t", str(tmp_path / "trn.txt"), "-m", model, "-o", str(tmp_path / "emb"), "--device", "cpu"])
    assert np.load(tmp_path / "emb.npy").shape == (64, 32)


def test_skeleton_and_entry_points_without_gpu(tiny, capsys):
    from pecos_tpu_torch.xmc.xtransformer import train

    train.main(["--generate-params-skeleton"])
    skel = json.loads(capsys.readouterr().out)
    assert XTransformer.TrainParams.from_dict(skel["train_params"]).matcher_params_chain.model_type == "distilbert"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    prob = MLProblemWithText(tiny["corpus"], tiny["Y"])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        TransformerMatcher.train(prob, train_params=_train_params(tiny["model_config"], epochs=1))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        XTransformer.train(prob, train_params=dict(matcher_params_chain=_train_params(tiny["model_config"], epochs=1)))
    with pytest.raises(NotImplementedError, match="vocab_file"):
        TransformerMatcher.download_model(TransformerMatcher.TrainParams(model_type="roberta", model_config=dict(tiny["model_config"])))
