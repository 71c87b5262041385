"""The sparse-expert XR-Transformer kind (``portbench/models/xtransformer_moe*.py``)
in whole tiny CPU cells through ``harness.run_cell``: a sound run in float32
is correct to 1e-5, and an encoder that drops the routed experts reads not
correct; on the card, a bfloat16 run through the grouped GEMM kernel reads
the kind's metrics.  Also its
calibration, its work count and what its reference imports."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.models import xtransformer_moe, xtransformer_moe_reference, xtransformer_moe_work
from portbench.tests import conftest

CPU = torch.device("cpu")
# Moonlight-16B-A3B's keys at tiny widths: 3 layers (one dense), 8 experts (top 2, 1 shared);
# hidden 128 and expert width 64 are the grouped GEMM kernel's smallest shapes, so the cell runs on the card too
TINY_MOONLIGHT = dict(
    hidden_size=128, num_hidden_layers=3, first_k_dense_replace=1, intermediate_size=192, moe_intermediate_size=64,
    n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1, kv_lora_rank=16, qk_rope_head_dim=8,
    qk_nope_head_dim=16, v_head_dim=16, num_attention_heads=4, num_key_value_heads=4, q_lora_rank=None, n_group=1,
    topk_group=1, routed_scaling_factor=2.446, norm_topk_prob=True, rms_norm_eps=1e-5, rope_theta=50000,
    vocab_size=300, max_position_embeddings=64, initializer_range=0.02, model_type="deepseek_v3", hidden_act="silu",
    scoring_func="sigmoid", topk_method="noaux_tc",
)
# the encoder check's limit at these widths: bfloat16 reads ~0.0076 and the
# float8 expert GEMMs ~0.042 on the CPU, float32 ~2e-7
CONFIG = dict(conftest.TINY_CONFIG, name="tinymoe", model="xtransformer_moe", encoder_type="deepseek_v3",
              encoder_keys=list(TINY_MOONLIGHT), truncate_length=16, encoder_batch=256, max_match_clusters=256,
              calibration={"texts": 64, "steps": 50, "gamma": 0.01,
                           "text_words": {"law": "lognormal", "median": 10, "sigma": 1.0, "min": 2, "max": 40}},
              encoder_check={"texts": 16, "limit": 0.02}, **TINY_MOONLIGHT)
MIX = dict(conftest.TINY_BATCH, pool=256, block=64, batch_size=64,
           text_words={"law": "lognormal", "median": 10, "sigma": 1.0, "min": 2, "max": 40})
CELL = "tinymoe-batch"
SEED = 2**31 + 91
# bfloat16 against the float32 reference: at width 128 with random routers a
# rounding flips tokens between experts, and a run's scores depart by up to
# ~0.26 (a CPU run reads 0.258); the card's tiny run is held to twice that
BF16_LIMITS = dict(conftest.LIMITS, value_err=0.5)


def make_root(tmp_path, dtype="float32", **over):
    root = conftest.make_tiny_root(tmp_path)
    dst = os.path.join(root, "portbench")
    conftest.write_json(os.path.join(dst, "configs", "tinymoe.json"), dict(CONFIG, dtype=dtype, **over))
    conftest.write_json(os.path.join(dst, "traffic", CELL + ".json"), MIX)
    limits = conftest.LIMITS if dtype == "float32" else BF16_LIMITS
    conftest.write_json(os.path.join(dst, "cells", CELL + ".json"), {"limits": limits})
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tinymoe", "source": "test", "file": "portbench/configs/tinymoe.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "tinymoe", "traffic": CELL, "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "xtransformer-moonlight-wiki500k-batch" in m.get("workloads", []):
            m["workloads"].append(CELL)
    conftest.write_json(path, bench)
    return root


@pytest.fixture
def moe_root(tmp_path):
    return make_root(tmp_path)


def run(root, trace=False, seconds=1.0, device=CPU):
    lines = []
    res = harness.run_cell(CELL, SEED, seconds, trace, device, time.perf_counter(), root=root, log=lines.append)
    return res, lines


def test_a_sound_run_is_correct(moe_root):
    res, _ = run(moe_root)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["checks"]["value_err"]["value"] < 1e-5
    assert set(res["metrics"]) == {"qps", "setup_s"}


def test_an_encoder_without_its_routed_experts_is_not_correct(tmp_path, monkeypatch):
    """With the set-up check passed over (its limit out of reach), the
    comparison after the window alone reads the fault."""
    from pecos_tpu_torch.xmc.xtransformer import moe

    monkeypatch.setattr(moe.ExpertLayer, "routed", lambda self, x, keep: torch.zeros_like(x))
    res, _ = run(make_root(tmp_path, encoder_check={"texts": 16, "limit": 1e9}))
    assert not res["correct"], res["checks"]
    assert res["checks"]["value_err"]["value"] > 1e-3


@pytest.mark.parametrize("fault", ["no_routed_experts", "float8_experts"])
def test_an_encoder_fault_fails_the_set_up_check(moe_root, monkeypatch, fault):
    """The routed experts dropped, or their GEMMs' operands rounded to
    float8 (e4m3, a scale a row): set-up stops at the encoder check."""
    from pecos_tpu_torch.xmc.xtransformer import moe

    if fault == "no_routed_experts":
        monkeypatch.setattr(moe.ExpertLayer, "routed", lambda self, x, keep: torch.zeros_like(x))
    else:
        def e4m3(x):
            s = x.abs().amax(-1, keepdim=True).clamp(min=1e-30) / torch.finfo(torch.float8_e4m3fn).max
            return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s

        gemm = moe.grouped_gemm
        monkeypatch.setattr(moe, "grouped_gemm", lambda a, w, offsets: gemm(e4m3(a), e4m3(w), offsets))
    with pytest.raises(RuntimeError, match="encoder check"):
        run(moe_root)


def test_the_encoder_check_reads_each_layer(moe_root):
    """Float32 reads each layer within rounding of the reference; the
    routed experts dropped read far off in the expert layers only."""
    from pecos_tpu_torch.xmc.xtransformer import moe

    cell = harness.Cell(CELL, moe_root)
    model = xtransformer_moe.Model(cell.cfg, 7, CPU)
    assert len(model.layer_errors) == TINY_MOONLIGHT["num_hidden_layers"]
    assert max(model.layer_errors) < 1e-5
    mc = xtransformer_moe_reference.model_config(cell.cfg)
    words = model.vocab[5:]
    ids, mask = xtransformer_moe_reference.tokens(model.vocab, [" ".join(words[:3]), " ".join(words[3:30])], 16)
    ref = xtransformer_moe_reference.Encoder(dict(model.encoder.state_dict()), mc, CPU)
    routed = moe.ExpertLayer.routed
    try:
        moe.ExpertLayer.routed = lambda self, x, keep: torch.zeros_like(x)
        errors = xtransformer_moe.layer_errors(model.encoder, ref, ids, mask, CPU)
    finally:
        moe.ExpertLayer.routed = routed
    assert errors[0] < 1e-5 and min(errors[1:]) > 0.1


def test_the_encoder_is_drawn_by_the_benchmark():
    """Every tensor of the program's module by name: norms 1, correction
    biases 0, the rest from their own seeds (one seed, one model), rounded
    to the dtype; the module holds the drawn tensors."""
    mc = dict(TINY_MOONLIGHT)
    enc = xtransformer_moe.draw_encoder("deepseek_v3", mc, 11, CPU, torch.bfloat16)
    again = xtransformer_moe.draw_encoder("deepseek_v3", mc, 11, CPU, torch.bfloat16).state_dict()
    other = xtransformer_moe.draw_encoder("deepseek_v3", mc, 12, CPU, torch.bfloat16).state_dict()
    state = enc.state_dict()
    for name, t in state.items():
        assert torch.equal(t, again[name])
        if name.endswith("norm.weight"):
            assert torch.all(t == 1) and t.dtype == torch.bfloat16
        elif name.endswith("e_score_correction_bias"):
            assert torch.all(t == 0) and t.dtype == torch.float32
        else:
            g = torch.Generator().manual_seed(xtransformer_moe.tensor_seed(11, name))
            want = (0.02 * torch.randn(t.shape, generator=g)).to(torch.bfloat16)
            assert torch.equal(t, want) and not torch.equal(t, other[name]), name
    assert enc.layers[1].mlp.experts.gate_up.data_ptr() == state["layers.1.mlp.experts.gate_up"].data_ptr()


def test_calibration_balances_the_experts_and_centres_the_dense_weights(moe_root):
    cell = harness.Cell(CELL, moe_root)
    model = xtransformer_moe.Model(cell.cfg, 7, CPU)
    assert sorted(model.balance) == [1, 2]
    for before, after in model.balance.values():
        assert after < before and after < 1.5
    bias = model.encoder.layers[1].mlp.gate.e_score_correction_bias
    assert bias.dtype == torch.float32 and bias.abs().max() > 0
    # the dense weights of every node are orthogonal to the sample's mean direction
    H, D = TINY_MOONLIGHT["hidden_size"], CONFIG["nr_features"]
    dense = np.concatenate([v[:, -H - 1 : -1] for v in model.vals]).astype(np.float64)
    assert np.abs(dense @ model.direction.double().numpy()).max() < 1e-5 * np.abs(dense).max() * np.sqrt(H)
    assert model.D == D + H


def test_balance_bias_moves_load_off_the_favoured_experts():
    scores = torch.rand(4000, 8)
    scores[:, 0] += 0.5  # every token prefers expert 0
    bias = xtransformer_moe_reference.balance_bias(scores, 2, 200, 0.01)
    load = torch.bincount(torch.topk(scores + bias, 2).indices.reshape(-1), minlength=8).float()
    assert bias[0] < bias[1:].min() and load.max() / load.mean() < 1.2


def test_the_work_counts_the_expert_pairs_and_launches(moe_root):
    cell = harness.Cell(CELL, moe_root)
    model = xtransformer_moe.Model(cell.cfg, 7, CPU)
    Q = xtransformer_moe.queries(model, 32, np.full(32, 10), cell.mix, 7, CPU)
    ref = xtransformer_moe_reference.build(model, cell.cfg, CPU)
    peaks = {"hbm_bytes_per_s": 1e12, "fp32_flop_per_s": 1e12}
    tpeaks = {"hbm_bytes_per_s": 1e12, "bf16_flop_per_s": 1e13}
    got = xtransformer_moe_work.traced(ref, model, [Q[0:16], Q[16:32]], cell.cfg, peaks, tpeaks)
    tokens = ref.real_tokens(Q.texts)
    mc = TINY_MOONLIGHT
    pairs = int(tokens.sum()) * mc["num_experts_per_tok"]
    H, I, E = mc["hidden_size"], mc["moe_intermediate_size"], mc["n_routed_experts"]
    forwards, layers = 2, 2  # a forward a batch of 16 texts; two expert layers, two launches each
    assert got["moe"]["pairs"] == pairs and got["moe"]["calls"] == forwards * layers * 2
    assert got["moe"]["ops"] == 2 * layers * pairs * (2 * I * H + H * I)
    # bfloat16: each launch reads its rows and its 64 experts' weights and writes its rows once
    weights = E * 2 * I * H + E * H * I
    assert got["moe"]["bytes"] == 2 * (forwards * layers * weights + layers * pairs * (H + 2 * I + I + H))
    assert got["encoder"]["texts"] == 32 and got["encoder"]["tokens"] == int(tokens.sum())
    assert got["predict"]["seconds"] == pytest.approx(got["ranker"]["seconds"] + got["encoder"]["seconds"])
    assert "moe" not in xtransformer_moe_work.traced(ref, model, [Q[0:16]], cell.cfg, peaks, None) or \
        xtransformer_moe_work.tensor_peaks() is not None


def test_moonlight_operations_a_token():
    """27 layers at 128 slots: 4.52 GFLOP a token, ~579 GFLOP a text; 15.29B
    weights besides the embedding."""
    with open(os.path.join(conftest.BENCH_DIR, "configs", "xtransformer-moonlight-wiki500k.json")) as f:
        cfg = json.load(f)
    mc = xtransformer_moe_reference.model_config(cfg)
    one = xtransformer_moe_work.forward_work(mc, 1, 128, 128, {"bf16_flop_per_s": 1.0, "hbm_bytes_per_s": 1.0})
    assert 578.8e9 < one["encoder"]["ops"] < 579.0e9
    assert 15.28e9 < xtransformer_moe_work.weight_count(mc) < 15.30e9
    assert one["moe"]["calls"] == 2 * 26


def test_the_configuration_keeps_the_published_keys():
    with open(os.path.join(conftest.BENCH_DIR, "configs", "xtransformer-moonlight-wiki500k.json")) as f:
        cfg = json.load(f)
    assert cfg["reduced"] == [] and cfg["dtype"] == "bfloat16"
    assert (cfg["num_hidden_layers"], cfg["n_routed_experts"], cfg["num_experts_per_tok"], cfg["vocab_size"]) == \
        (27, 64, 6, 163840)
    assert set(cfg["encoder_keys"]) <= set(cfg)


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import portbench.models.xtransformer_moe_reference, "
            "portbench.models.xtransformer_moe_work; print(sorted({m.split('.')[0] for m in sys.modules}))"
            % os.path.dirname(conftest.BENCH_DIR))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    tops = set(eval(out.stdout))
    assert not tops & {"pecos_tpu_torch", "transformers", "tokenizers", "jax", "jaxlib", "flax", "pecos_tpu"}


@pytest.mark.card
def test_the_tiny_cell_on_the_card(card, tmp_path):
    """On the card, in bfloat16 through the grouped GEMM kernel: the traced
    run is correct within the tiny limit and reads the kind's three metrics."""
    from pecos_tpu_torch.ops.grouped_gemm import grouped_gemm

    before = grouped_gemm.launches
    res, _ = run(make_root(tmp_path, "bfloat16"), trace=True, device=card)
    assert res["correct"], res["checks"]
    assert grouped_gemm.launches > before
    assert {"expert_roofline.textbatch", "expert_load.textbatch", "moe_mfu.textbatch"} <= set(res["metrics"])
