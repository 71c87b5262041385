"""The port's XMR reranker against the JAX package, on the CPU at tiny widths
(tests/test_reranker.py's toy: DistilBERT dim 16, one layer).

- the three losses equal the JAX package's within rtol 1e-6;
- the numeric tower (tanh-approximated GELU, jax.nn.gelu's default) equals
  its MLP within 1e-6, and is told apart from the exact GELU;
- LoRA: the same target paths and A draws as the JAX package; with adapters
  carried over (B made non-zero) the pooled embedding equals the JAX
  package's merged-weight forward within atol 2e-4 / rtol 2e-3;
- the port's train meets tests/test_reranker.py's ranking bar (> 0.8) for
  each loss, with LoRA too, where the frozen base stays bit-equal;
- folders move both ways with scores within atol 1e-5; parquet streaming
  where pandas and pyarrow are present; every entry point raises without a GPU.
"""

import os

import numpy as np
import pytest
import torch

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

from pecos_tpu_torch.xmc.xtransformer import network  # noqa: E402
from pecos_tpu_torch.xmr.reranker import RankingModel  # noqa: E402
from pecos_tpu_torch.xmr.reranker import model as rmodel  # noqa: E402

ENC_ATOL, ENC_RTOL = 2e-4, 2e-3
TRUNC = 12  # the toy's max_position_embeddings is 32


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp("trr")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "good", "bad", "query", "item"]
    vf = d / "vocab.txt"
    vf.write_text("\n".join(vocab) + "\n")
    model_config = dict(vocab_size=len(vocab), dim=16, n_layers=1, n_heads=2, hidden_dim=32, max_position_embeddings=32,
                        vocab_file=str(vf))
    rng = np.random.default_rng(0)
    inputs, labels, numr = [], [], []
    for q in range(24):
        for rel in [1.0, 0.0, 0.0, 0.0]:
            inputs.append(f"query {q} [SEP] {'good' if rel > 0 else 'bad'} item")
            labels.append(rel)
            numr.append([rel * 2 - 1 + rng.normal() * 0.1, rng.normal()])
    return inputs, np.array(labels, np.float32), np.array(numr, np.float32), model_config


def _params(model_config, **kw):
    return dict(dict(model_type="distilbert", model_config=model_config, truncate_length=TRUNC, batch_size=16,
                     num_train_epochs=6, learning_rate=3e-3, group_size=4), **kw)


def _acc(model, inputs, numr):
    s = model.predict(inputs, numeric_feats=numr, truncate_length=TRUNC).reshape(-1, 4)
    return (s.argmax(axis=1) == 0).mean()


@pytest.mark.parametrize("kind", ["pointwise", "pairwise", "listwise"])
def test_losses_equal_jax(kind):
    import jax.numpy as jnp

    from pecos_tpu.xmr.reranker import RankingModel as JaxModel

    rng = np.random.default_rng(1)
    logits = rng.standard_normal((6, 4)).astype(np.float32)
    labels = np.where(rng.random((6, 4)) < 0.3, rng.random((6, 4)), 0.0).astype(np.float32)
    want = float(JaxModel._loss(jnp.asarray(logits), jnp.asarray(labels), kind, 0.3))
    got = float(rmodel.ranking_loss(torch.from_numpy(logits), torch.from_numpy(labels), kind, 0.3))
    assert got == pytest.approx(want, rel=1e-6)


def test_numr_tower_tanh_gelu_equals_jax():
    import jax.numpy as jnp

    from pecos_tpu.xmr.reranker.model import _mlp_apply, _mlp_init as jax_init

    layers = jax_init(np.random.default_rng(3), (5, 16, 8))
    for a, b in zip(rmodel._mlp_init(np.random.default_rng(3), (5, 16, 8)), layers):
        np.testing.assert_array_equal(a["w"], b["w"])
    x = (np.random.default_rng(4).standard_normal((7, 5)) * 2).astype(np.float32)
    want = np.asarray(_mlp_apply([{k: jnp.asarray(v) for k, v in l.items()} for l in layers], jnp.asarray(x)))
    tower = rmodel.NumrTower(layers)
    with torch.no_grad():
        got = tower(torch.from_numpy(x)).numpy()
        lin = tower.linears
        exact = lin[1](torch.nn.functional.gelu(lin[0](torch.from_numpy(x)))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.abs(exact - want).max() > 1e-5  # the exact GELU would not match
    for a, b in zip(tower.to_params(), layers):
        np.testing.assert_array_equal(a["w"], b["w"])


def test_lora_forward_equals_jax_with_carried_adapters():
    from pecos_tpu.xmc.xtransformer import network as jnet
    from pecos_tpu.xmr.reranker import model as jmodel
    from transformers import DistilBertConfig, FlaxDistilBertModel

    cfg = dict(vocab_size=40, dim=16, n_layers=2, n_heads=2, hidden_dim=32, max_position_embeddings=32)
    fx = FlaxDistilBertModel(DistilBertConfig(**cfg), seed=2)
    pt = network.resolve_encoder("distilbert")[1](DistilBertConfig(**cfg)).eval()
    network.load_state_strict(pt, network.encoder_state_from_flax(fx.params, "distilbert"))
    targets = ("q_lin", "v_lin")
    paths = jmodel.lora_target_paths(fx.params, targets)
    assert rmodel.lora_target_paths(pt, targets) == paths and len(paths) == 4
    want_ad = jmodel.lora_init(fx.params, paths, 4, seed=5)
    got_ad = rmodel.lora_init(pt, paths, 4, seed=5)
    rng = np.random.default_rng(6)
    for p in paths:
        np.testing.assert_array_equal(got_ad[p]["a"], want_ad[p]["a"])
        want_ad[p]["b"] = got_ad[p]["b"] = rng.standard_normal(want_ad[p]["b"].shape).astype(np.float32)
    base = {k: v.clone() for k, v in pt.state_dict().items()}
    rmodel.lora_apply(pt, got_ad, alpha=8.0)
    ids = rng.integers(5, 40, size=(3, 10)).astype(np.int32)
    am = np.ones((3, 10), np.int32)
    am[2, 6:] = 0
    want = np.asarray(jnet.pooled_embedding(fx(input_ids=ids, attention_mask=am,
                                                params=jmodel.lora_apply(fx.params, want_ad, 8.0)), am))
    with torch.no_grad():
        mm = torch.from_numpy(am.astype(np.int64))
        got = network.pooled_embedding(pt(input_ids=torch.from_numpy(ids.astype(np.int64)), attention_mask=mm), mm).numpy()
    np.testing.assert_allclose(got, want, atol=ENC_ATOL, rtol=ENC_RTOL)
    with torch.no_grad():
        plain = pt.transformer.layer[0].attention.q_lin.base
        assert torch.equal(plain.weight, base["transformer.layer.0.attention.q_lin.weight"])
    merged = rmodel.lora_merged(pt)
    assert not any(isinstance(m, rmodel.LoRALinear) for m in merged.modules())
    with torch.no_grad():
        got_m = network.pooled_embedding(merged(input_ids=torch.from_numpy(ids.astype(np.int64)), attention_mask=mm), mm).numpy()
    np.testing.assert_allclose(got_m, got, atol=1e-5)


@pytest.mark.parametrize("loss", ["pointwise", "pairwise", "listwise"])
def test_train_ranks_relevant_higher(tiny, loss):
    inputs, labels, numr, mc = tiny
    model = RankingModel.train(inputs, labels, numeric_feats=numr, train_params=_params(mc, loss_fn=loss), device="cpu")
    assert _acc(model, inputs, numr) > 0.8, loss
    assert model.train_losses[-6:].mean() < model.train_losses[:6].mean()


def test_lora_train_ranks_and_base_stays_frozen(tiny):
    inputs, labels, numr, mc = tiny
    model = RankingModel.train(inputs, labels, numeric_feats=numr, train_params=_params(mc, loss_fn="pairwise", lora_rank=4),
                               device="cpu")
    assert _acc(model, inputs, numr) > 0.8
    init = network.random_encoder("distilbert", mc, seed=0).state_dict()
    assert len(model.lora) == 2
    for name, w in model.enc.encoder.named_modules():
        if isinstance(w, rmodel.LoRALinear):
            assert torch.equal(w.base.weight, init[name + ".weight"]) and torch.equal(w.base.bias, init[name + ".bias"])
            assert float(w.lora_b.detach().abs().max()) > 0
    plain = {k.replace(".base.", "."): v for k, v in model.enc.encoder.state_dict().items() if "lora_" not in k}
    assert all(torch.equal(v, init[k]) for k, v in plain.items())


def test_folders_both_ways(tiny, tmp_path):
    from pecos_tpu.xmr.reranker import RankingModel as JaxModel

    inputs, labels, numr, mc = tiny
    tp = _params(mc, num_train_epochs=1, batch_size=8, lora_rank=2)
    port = RankingModel.train(inputs[:16], labels[:16], numeric_feats=numr[:16], train_params=tp, device="cpu")
    port.save(str(tmp_path / "port"))
    s_port = port.predict(inputs[:8], numeric_feats=numr[:8], truncate_length=TRUNC)
    again = RankingModel.load(str(tmp_path / "port"), device="cpu")
    np.testing.assert_allclose(again.predict(inputs[:8], numeric_feats=numr[:8], truncate_length=TRUNC), s_port, atol=1e-5)
    jax_loaded = JaxModel.load(str(tmp_path / "port"))
    np.testing.assert_allclose(jax_loaded.predict(inputs[:8], numeric_feats=numr[:8], truncate_length=TRUNC), s_port, atol=1e-5)
    jm = JaxModel.train(inputs[:16], labels[:16], numeric_feats=numr[:16], train_params=dict(tp, lora_rank=0))
    jm.save(str(tmp_path / "jax"))
    loaded = RankingModel.load(str(tmp_path / "jax"), device="cpu")
    np.testing.assert_allclose(loaded.predict(inputs[:8], numeric_feats=numr[:8], truncate_length=TRUNC),
                               jm.predict(inputs[:8], numeric_feats=numr[:8], truncate_length=TRUNC), atol=1e-5)
    assert loaded.enc.numr_dim == 2 and len(loaded.enc.numr_params) == 1


def test_train_streaming_parquet(tiny, tmp_path):
    pd = pytest.importorskip("pandas")
    pytest.importorskip("pyarrow")
    from pecos_tpu_torch.xmr.reranker.model import RankingDataUtils

    _, _, _, mc = tiny
    rows = [{"query": f"query {q}", "item": f"{'good' if rel > 0 else 'bad'} item", "relevance": rel}
            for q in range(24) for rel in [1.0, 0.0, 0.0, 0.0]]
    df = pd.DataFrame(rows)
    (tmp_path / "shards").mkdir()
    for i in range(3):
        df.iloc[i * 32 : (i + 1) * 32].to_parquet(tmp_path / "shards" / f"part-{i}.parquet")
    assert RankingDataUtils.get_parquet_rows(str(tmp_path / "shards")) == 96
    assert [len(s) for s in RankingDataUtils.iter_parquet_shards(str(tmp_path / "shards"))] == [32] * 3
    inputs, labels = RankingDataUtils.build_pairs(RankingDataUtils.load_parquet([str(tmp_path / "shards" / "part-0.parquet")]))
    assert inputs[0] == "query 0 [SEP] good item" and labels[:4].tolist() == [1.0, 0.0, 0.0, 0.0]
    model = RankingModel.train_streaming(str(tmp_path / "shards"), train_params=_params(mc, loss_fn="pairwise"), device="cpu")
    s = model.predict(["q [SEP] good item", "q [SEP] bad item"], batch_size=2, truncate_length=TRUNC)
    assert s[0] > s[1]


def test_entry_points_raise_without_gpu(tiny):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    inputs, labels, numr, mc = tiny
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        RankingModel.train(inputs[:8], labels[:8], train_params=_params(mc, num_train_epochs=1))
    with pytest.raises(ValueError, match="divisible by group_size"):
        RankingModel.train(inputs[:6], labels[:6], train_params=_params(mc, loss_fn="pairwise"), device="cpu")
