"""The deepseek_v3 encoder family (Moonlight-16B-A3B's architecture) and its
expert layer: ``pecos_tpu_torch/xmc/xtransformer/{moe,moe_encoder}.py``.

On the CPU at a tiny Moonlight-shaped configuration: the float32 encoder
against the benchmark's plain reference and against ``transformers``'
DeepseekV3Model (the published modeling code); bfloat16 within rounding; the
routing rule; dropped pad slots; ``XTransformer.predict`` end to end; the
BERT family's embeddings as the code before this family computed them.  The
card's tests (``test_cuda_*``) skip without a card; on the card, where there
is no JAX, run them without the tests' ``conftest.py``:

    python -m pytest --noconftest tests/test_torch_moe.py -k cuda
"""

import json
import os

import numpy as np
import pytest
import scipy.sparse as smat
import torch

from pecos_tpu_torch.xmc.xtransformer import moe, network
from pecos_tpu_torch.xmc.xtransformer.moe_encoder import DeepseekV3Encoder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Moonlight-16B-A3B's keys at tiny widths: hidden 64; 3 layers, one dense; 8 experts, top-2, 1 shared; kv rank 16; rope 8
TINY = dict(
    hidden_size=64, num_hidden_layers=3, first_k_dense_replace=1, intermediate_size=96, moe_intermediate_size=32,
    n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1, kv_lora_rank=16, qk_rope_head_dim=8,
    qk_nope_head_dim=16, v_head_dim=16, num_attention_heads=4, num_key_value_heads=4, q_lora_rank=None, n_group=1,
    topk_group=1, routed_scaling_factor=2.446, norm_topk_prob=True, rms_norm_eps=1e-5, rope_theta=50000,
    vocab_size=100, max_position_embeddings=64, initializer_range=0.02, model_type="deepseek_v3", hidden_act="silu",
    scoring_func="sigmoid", topk_method="noaux_tc",
)


def tokens(seed, n=16, T=12):
    """Right-padded ids and masks: a few texts shorter than T."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(5, TINY["vocab_size"], (n, T), generator=g)
    mask = torch.ones((n, T), dtype=torch.int64)
    for r, length in ((1, 3), (4, 7), (9, 1)):
        mask[r, length:] = 0
        ids[r, length:] = 0
    return ids, mask


def encoder(seed=3, dtype=torch.float32, biased=True, **over):
    enc = network.random_encoder("deepseek_v3", dict(TINY, **over), seed=seed, dtype=dtype)
    if biased:  # correction biases that change choices
        g = torch.Generator().manual_seed(seed)
        for layer in enc.layers[TINY["first_k_dense_replace"] :]:
            layer.mlp.gate.e_score_correction_bias.copy_(0.05 * torch.randn(TINY["n_routed_experts"], generator=g))
    return enc


def reference_pooled(enc, ids, mask, mc=TINY):
    from portbench.models import xtransformer_moe_reference

    return xtransformer_moe_reference.Encoder(dict(enc.state_dict()), mc, torch.device("cpu")).pooled(
        ids.numpy(), mask.numpy())


def rel(a, b):
    return float(((a.float() - b.float()).norm(dim=1) / b.float().norm(dim=1)).max())


def test_float32_encoder_matches_the_plain_reference():
    enc = encoder()
    ids, mask = tokens(1)
    with torch.no_grad():
        got = network.pooled_embedding(enc(ids, mask), mask)
    assert got.dtype == torch.float32
    assert rel(got, reference_pooled(enc, ids, mask)) < 1e-5


def test_float32_encoder_matches_the_published_modeling_code():
    """transformers' DeepseekV3Model (eager attention) on the same weights,
    the experts unstacked: the real tokens' last hidden states agree to
    float32 rounding."""
    import transformers

    enc = encoder()
    cfg = transformers.DeepseekV3Config(**TINY)
    cfg._attn_implementation = "eager"
    hf = transformers.DeepseekV3Model(cfg).eval()
    state = {}
    for k, v in enc.state_dict().items():
        head, _, leaf = k.rpartition(".")
        if head.endswith("mlp.experts") and leaf in ("gate_up", "down"):
            for e in range(v.shape[0]):
                if leaf == "gate_up":
                    width = v.shape[1] // 2
                    state[f"{head}.{e}.gate_proj.weight"], state[f"{head}.{e}.up_proj.weight"] = v[e, :width], v[e, width:]
                else:
                    state[f"{head}.{e}.down_proj.weight"] = v[e]
        else:
            state[k] = v
    hf.load_state_dict(state, strict=True)
    ids, mask = tokens(2)
    with torch.no_grad():
        got = enc(ids, mask).last_hidden_state
        want = hf(input_ids=ids, attention_mask=mask).last_hidden_state
    real = mask.bool()
    assert float((got - want)[real].abs().max()) < 1e-5 * float(want[real].abs().max())


def test_bfloat16_encoder_within_rounding_of_the_reference():
    """With every expert chosen (top-k = all 8), no rounding can change a
    choice, so what is left is bfloat16's: some twenty roundings of 2^-9 in
    series through three layers, 0.7-0.8% of a pooled output at these
    widths; 2e-2 leaves 2.5x room.  (With top-2, a rounding that flips a
    token's choice moves its output by a whole expert's: 1-4% here, by no
    rule of rounding.)"""
    enc = encoder(dtype=torch.bfloat16, biased=False, num_experts_per_tok=8)
    assert enc.layers[1].mlp.experts.gate_up.dtype == torch.bfloat16
    assert enc.layers[1].mlp.gate.e_score_correction_bias.dtype == torch.float32
    ids, mask = tokens(3)
    with torch.no_grad():
        got = network.pooled_embedding(enc(ids, mask), mask)
    assert got.dtype == torch.float32
    err = rel(got, reference_pooled(enc, ids, mask, dict(TINY, num_experts_per_tok=8)))
    assert 1e-4 < err < 2e-2


def test_routing_rule_on_crafted_scores():
    """Sigmoid scores; the bias picks the experts, the unbiased scores weigh
    them, normalised to sum 1, times the scaling factor."""
    E, H = 4, 2
    weight = torch.tensor([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.5, 0.5]])
    x = torch.tensor([[2.0, 1.0]])
    s = torch.sigmoid(x @ weight.T)[0]  # scores 0.881, 0.731, 0.119, 0.818
    experts, gates = moe.route(x, weight, torch.zeros(E), 2, 2.446)
    assert sorted(experts[0].tolist()) == [0, 3]
    assert torch.allclose(gates.sum(), torch.tensor(2.446))
    lifted = torch.tensor([0.0, 0.0, 2.0, 0.0])  # expert 2 chosen for its bias, weighed by its own low score
    experts, gates = moe.route(x, weight, lifted, 2, 2.446)
    chosen = dict(zip(experts[0].tolist(), gates[0].tolist()))
    assert sorted(chosen) == [0, 2]
    assert chosen[2] == pytest.approx(2.446 * float(s[2] / (s[0] + s[2])))
    assert chosen[0] == pytest.approx(2.446 * float(s[0] / (s[0] + s[2])))
    _, raw = moe.route(x, weight, lifted, 2, 1.0, normalize=False)
    assert sorted(raw[0].tolist()) == pytest.approx(sorted([float(s[2]), float(s[0])]))


def test_expert_layer_matches_a_loop_over_tokens():
    torch.manual_seed(0)
    layer = moe.ExpertLayer(16, 8, 6, 3, 1, 2.446)
    for p in layer.parameters():
        torch.nn.init.normal_(p, std=0.3)
    x = torch.randn(40, 16)
    keep = torch.rand(40) > 0.2
    with torch.no_grad():
        got = layer(x, keep)
        want = layer.shared_experts(x)
        experts, gates = moe.route(x, layer.gate.weight, layer.gate.e_score_correction_bias, 3, 2.446)
        gu, down = layer.experts.gate_up, layer.experts.down
        for t in range(40):
            if keep[t]:
                for e, g in zip(experts[t].tolist(), gates[t].tolist()):
                    h = gu[e] @ x[t]
                    want[t] += g * (down[e] @ (torch.nn.functional.silu(h[:8]) * h[8:]))
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)


def test_dropped_pad_slots_leave_the_pooled_outputs_bit_equal(monkeypatch):
    """The expert layers compute no pair of a pad token; computing them
    changes no real token's output and no pooled output, bit for bit."""
    enc = encoder()
    ids, mask = tokens(4)
    with torch.no_grad():
        dropped = enc(ids, mask)
        forward = moe.ExpertLayer.forward
        monkeypatch.setattr(moe.ExpertLayer, "forward",
                            lambda self, x, keep: forward(self, x, torch.ones_like(keep)))
        kept = enc(ids, mask)
    assert torch.equal(network.pooled_embedding(dropped, mask), network.pooled_embedding(kept, mask))
    real = mask.bool()
    assert torch.equal(dropped.last_hidden_state[real], kept.last_hidden_state[real])
    assert torch.all(dropped.last_hidden_state[~real].isfinite())


def test_pairs_and_the_busiest_expert_are_counted_on_the_device():
    from pecos_tpu_torch.utils import profile_util

    moe.take_counts("cpu")  # what earlier forwards left
    profile_util.reset()
    enc = encoder()
    ids, mask = tokens(5)
    with torch.no_grad():
        enc(ids, mask)
    pairs, busiest = moe.take_counts("cpu")
    assert pairs == 2 * TINY["num_experts_per_tok"] * int(mask.sum())  # two expert layers, pads dropped
    assert pairs / 2 / TINY["n_routed_experts"] <= busiest <= pairs
    assert moe.take_counts("cpu") == (0, 0)
    c = profile_util.snapshot()["counters"]
    assert c["pecos.moe.pairs"] == pairs and c["pecos.moe.max_load"] == busiest and c["pecos.moe.layers"] == 2
    profile_util.reset()


def test_layers_and_fused_layers_are_counted():
    """``pecos.moe.layers`` counts every expert layer forward and
    ``pecos.moe.fused`` those that ran the fused kernels: none on the CPU,
    where the unfused ops run."""
    from pecos_tpu_torch.utils import profile_util

    profile_util.reset()
    enc = encoder(dtype=torch.bfloat16)
    ids, mask = tokens(6)
    with torch.no_grad():
        enc(ids, mask)
        enc(ids, mask)
    c = profile_util.snapshot()["counters"]
    assert c["pecos.moe.layers"] == 4
    assert c.get("pecos.moe.fused", 0) == 0
    moe.take_counts("cpu")
    profile_util.reset()


def test_from_seed_draws_each_tensor_from_its_own_seed():
    a = network.random_encoder("deepseek_v3", TINY, seed=11)
    b = network.random_encoder("deepseek_v3", TINY, seed=11, dtype=torch.bfloat16)
    c = network.random_encoder("deepseek_v3", TINY, seed=12)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    for name, t in sa.items():
        assert torch.equal(sb[name], t.to(sb[name].dtype)), name
    w = "layers.1.mlp.experts.gate_up"
    assert not torch.equal(sa[w], sc[w])
    assert float(sa[w].std()) == pytest.approx(0.02, rel=0.05)
    assert torch.all(sa["norm.weight"] == 1) and torch.all(sa["layers.2.mlp.gate.e_score_correction_bias"] == 0)
    with pytest.raises(ValueError, match="drawn on the CPU"):
        network.random_encoder("bert", dict(hidden_size=8, num_hidden_layers=1, num_attention_heads=2,
                                            intermediate_size=8, vocab_size=20), dtype=torch.bfloat16)


def test_unsupported_settings_raise():
    with pytest.raises(NotImplementedError, match="q_lora_rank"):
        network.random_encoder("deepseek_v3", dict(TINY, q_lora_rank=8))
    with pytest.raises(NotImplementedError, match="n_group"):
        network.random_encoder("deepseek_v3", dict(TINY, n_group=2, topk_group=1))


@pytest.mark.parametrize("entry", ["load_encoder", "model_shortcut", "train", "save"])
def test_predict_only_family_raises_at_the_loaders_training_and_save(entry, tmp_path):
    """The family has no ``from_pretrained``: loading a checkpoint, a
    ``model_shortcut``, training and saving raise NotImplementedError and say
    so, before any weight is drawn or read."""
    from pecos_tpu_torch.xmc.xtransformer import TransformerMatcher

    params = dict(model_type="deepseek_v3", model_shortcut=str(tmp_path))
    with pytest.raises(NotImplementedError, match="predict-only"):
        if entry == "load_encoder":
            network.load_encoder(str(tmp_path), "deepseek_v3")
        elif entry == "model_shortcut":
            TransformerMatcher.download_model(TransformerMatcher.TrainParams.from_dict(params))
        elif entry == "train":
            TransformerMatcher.train(None, train_params=params, device="cpu")
        else:
            TransformerMatcher(encoder(), None, network.XMCHead.random(4, TINY["hidden_size"]),
                               device="cpu").save(str(tmp_path / "saved"))


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"w{i}" for i in range(TINY["vocab_size"] - 5)]
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_text("\n".join(words) + "\n")
    return str(path)


def test_xtransformer_predict_end_to_end_through_the_new_family(vocab_file):
    """``XTransformer.predict`` (concat-only) over the tiny encoder, built as
    a random-init matcher through ``download_model``, and a tiny ranker: the
    same labels and scores as the ranker over the reference's embeddings."""
    from pecos_tpu_torch.xmc import HierarchicalMLModel, MLModel
    from pecos_tpu_torch.xmc.xlinear import XLinearModel
    from pecos_tpu_torch.xmc.xtransformer import TransformerMatcher, XTransformer

    H, F, sizes = TINY["hidden_size"], 40, [4, 16, 64]
    params = TransformerMatcher.TrainParams.from_dict(
        dict(model_type="deepseek_v3", model_config=dict(TINY, vocab_file=vocab_file), seed=5))
    enc, tok = TransformerMatcher.download_model(params)
    assert isinstance(enc, DeepseekV3Encoder)
    rng = np.random.default_rng(0)
    Ws, Cs, n_par = [], [], 1
    for L in sizes:
        W = smat.csc_matrix(rng.standard_normal((F + H + 1, L)).astype(np.float32) * (rng.random((F + H + 1, L)) < 0.5))
        Ws.append(W)
        Cs.append(smat.csc_matrix((np.ones(L, np.float32), (np.arange(L), np.arange(L) * n_par // L)), shape=(L, n_par)))
        n_par = L
    ranker = XLinearModel(HierarchicalMLModel([MLModel(W, C, bias=1.0, device="cpu") for W, C in zip(Ws, Cs)]))
    matcher = TransformerMatcher(enc, tok, network.XMCHead.random(sizes[-1], H), pred_params=dict(truncate_length=10),
                                 device="cpu")
    xtf = XTransformer(matcher, ranker)
    texts = [" ".join(f"w{i}" for i in rng.integers(0, 90, n)) for n in rng.integers(1, 14, 24)]
    X = smat.random(len(texts), F, density=0.2, format="csr", random_state=1, dtype=np.float32)
    got = xtf.predict(texts, X_feat=X, only_topk=5, beam_size=3)
    from portbench.models import xtransformer_reference

    ids, mask = xtransformer_reference.tokens(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                                              + [f"w{i}" for i in range(TINY["vocab_size"] - 5)], texts, 10)
    emb = reference_pooled(enc, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    want = ranker.predict(TransformerMatcher.concat_features(X, emb), only_topk=5, beam_size=3)
    assert got.shape == (24, sizes[-1]) and got.nnz == 24 * 5
    assert np.array_equal(got.indices, want.indices)
    assert np.allclose(got.data, want.data, rtol=1e-5)


def test_bert_embeddings_are_computed_as_before():
    """``random_encoder`` of a transformers family draws as it did (torch's
    generator on the CPU, seeded, forked), and ``pooled_embedding`` returns
    the pooler's output, or for a family without one the float32 mean it
    computed before, bit for bit."""
    import transformers

    from pecos_tpu_torch.xmc.xtransformer.network import encode_batches, pooled_embedding

    cfg = dict(hidden_size=16, num_hidden_layers=1, num_attention_heads=2, intermediate_size=32, vocab_size=40,
               max_position_embeddings=16)
    enc = network.random_encoder("bert", cfg, seed=9)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(9)
        before = transformers.BertModel(transformers.BertConfig(**cfg)).eval()
    for (k, a), (_, b) in zip(enc.state_dict().items(), before.state_dict().items()):
        assert torch.equal(a, b), k
    g = torch.Generator().manual_seed(1)
    toks = {"input_ids": torch.randint(5, 40, (6, 8), generator=g).numpy(), "attention_mask": np.ones((6, 8), np.int64)}
    toks["attention_mask"][2, 5:] = 0
    got = encode_batches(enc, toks, "cpu")
    with torch.no_grad():
        want = before(input_ids=torch.from_numpy(toks["input_ids"]),
                      attention_mask=torch.from_numpy(toks["attention_mask"])).pooler_output
    assert torch.equal(got, want)
    h = torch.randn(3, 5, 16)
    m = torch.tensor([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [1, 0, 0, 0, 0]])
    out = type("Out", (), {"pooler_output": None, "last_hidden_state": h})()
    mm = m[..., None].to(h.dtype)
    assert torch.equal(pooled_embedding(out, m), (h * mm).sum(1) / torch.clamp(mm.sum(1), min=1.0))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the expert layer's grouped GEMM kernel has no CPU mode")
    return torch.device("cuda", 0)


def test_cuda_forward_of_two_blocks_at_moonlight_widths_never_waits_for_the_card(card):
    """Moonlight-16B-A3B at its published widths in bfloat16: two 256-text
    forwards of 128 slots (pads at the ends of some texts) under
    ``set_sync_debug_mode("error")``, which raises on any call that waits
    for the card; 2 grouped GEMM launches an expert layer and forward (the
    SwiGLU and the scatter-storing modes) and one combine, every layer
    counted as fused."""
    from pecos_tpu_torch.ops.expert_combine import expert_combine
    from pecos_tpu_torch.ops.grouped_gemm import grouped_gemm
    from pecos_tpu_torch.utils import profile_util

    def launches():
        return grouped_gemm.launches, expert_combine.launches

    with open(os.path.join(REPO, "portbench", "configs", "xtransformer-moonlight-wiki500k.json")) as f:
        cfg = json.load(f)
    mc = {k: cfg[k] for k in cfg["encoder_keys"]}
    enc = network.random_encoder("deepseek_v3", mc, seed=1, device=card, dtype=torch.bfloat16)
    g = torch.Generator(device=card).manual_seed(2)
    blocks = []
    for _ in range(2):
        ids = torch.randint(5, mc["vocab_size"], (256, 128), generator=g, device=card)
        lengths = torch.randint(8, 129, (256,), generator=g, device=card)
        blocks.append((ids, (torch.arange(128, device=card)[None, :] < lengths[:, None]).long()))
    torch.cuda.synchronize(card)
    before = launches()
    profile_util.reset()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            out = [network.pooled_embedding(enc(ids, mask), mask) for ids, mask in blocks]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(card)
    sparse = mc["num_hidden_layers"] - mc["first_k_dense_replace"]
    after = launches()
    assert (after[0] - before[0], after[1] - before[1]) == (2 * 2 * sparse, 2 * sparse)
    c = profile_util.snapshot()["counters"]
    assert c["pecos.moe.fused"] == c["pecos.moe.layers"] == 2 * sparse
    assert all(bool(o.isfinite().all()) and o.shape == (256, mc["hidden_size"]) for o in out)
    profile_util.reset()


def unfused_layer(layer, x, keep):
    """The expert layer as it ran before its fused kernels: the gather, the
    plain-store grouped GEMM, SiLU and the product, the kernel again, the
    rows put back in token order, a float32 bmm, where, the cast and the add
    of the shared experts.  Returns the output, act and the token-ordered
    rows, with the offsets, the order and the gates."""
    from pecos_tpu_torch.ops.grouped_gemm import grouped_gemm

    T, H = x.shape
    k, E, I = layer.top_k, layer.n_experts, layer.experts.width
    experts, gates = moe.route(x, layer.gate.weight, layer.gate.e_score_correction_bias, k, layer.scaling,
                               layer.normalize)
    flat = torch.where(keep[:, None].expand(T, k).reshape(-1), experts.reshape(-1), E)
    sorted_experts, order = torch.sort(flat, stable=True)
    offsets = torch.searchsorted(sorted_experts, torch.arange(E + 1, device=x.device))
    h = grouped_gemm(x[order // k], layer.experts.gate_up, offsets)
    act = torch.nn.functional.silu(h[:, :I]) * h[:, I:]
    y = grouped_gemm(act, layer.experts.down, offsets)
    pairs = torch.empty_like(y)
    pairs[order] = y
    routed = torch.bmm(gates[:, None, :], pairs.view(T, k, H).float())[:, 0]
    out = torch.where(keep[:, None], routed, 0.0).to(x.dtype) + layer.shared_experts(x)
    return out, act, pairs, offsets, order, gates


def test_cuda_expert_layer_within_a_unit_of_the_unfused_path_at_moonlight_widths(card):
    """One expert layer of Moonlight-16B-A3B (hidden 2,048, 64 experts of
    1,408, top-6, 2 shared) over 256 texts of 128 slots, ~7% pads: act and
    the token-ordered rows of the fused kernels bit-equal to the unfused
    path's, the output within a unit of bfloat16's last place (the combine
    sums in order, the bmm in its own), the share that differs printed; the
    pads' slots, which no kernel writes, set to NaN change no output."""
    from pecos_tpu_torch.ops import grouped_gemm as gg
    from pecos_tpu_torch.ops.expert_combine import expert_combine

    torch.manual_seed(0)
    H, I, E, k = 2048, 1408, 64, 6
    layer = moe.ExpertLayer(H, I, E, k, 2, 2.446, device=card, dtype=torch.bfloat16)
    with torch.no_grad():
        for p in layer.parameters():
            torch.nn.init.normal_(p, std=0.02)
        layer.gate.e_score_correction_bias.normal_(std=0.01)
        T = 256 * 128
        x = torch.randn((T, H), device=card).to(torch.bfloat16)
        keep = torch.rand(T, device=card) >= 0.07
        got = layer(x, keep)
        want, want_act, want_pairs, offsets, order, gates = unfused_layer(layer, x, keep)
        real = int(offsets[-1])
        act = gg.grouped_gemm_swiglu(x[order // k], layer.experts.gate_up, offsets)
        pairs = gg.grouped_gemm_scatter(act, layer.experts.down, offsets, order)
        pairs[order[real:]] = float("nan")
        again = expert_combine(pairs, gates, keep, layer.shared_experts(x))
    torch.cuda.synchronize(card)
    assert torch.equal(act[:real], want_act[:real])
    assert torch.equal(pairs[order[:real]], want_pairs[order[:real]])
    ulps = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()
    same_sign = (got.view(torch.int16) < 0) == (want.view(torch.int16) < 0)
    print(f"expert layer: {float((got != want).float().mean())!r} of the outputs differ from the unfused path's, "
          f"{real} pairs")
    assert bool(((ulps <= 1) & same_sign | (got == want)).all())
    assert bool(got.isfinite().all()) and torch.equal(again, got)
