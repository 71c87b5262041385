"""The XR-Transformer kind (``portbench/models/xtransformer*.py``) in whole
tiny CPU cells through ``harness.run_cell``: a sound run is correct, its
traced run reads the program's encoder spans and counters, and an encoder
that serves one text's embedding for every text, or that runs in bfloat16,
reads not correct.  Also its pool, its work count, and what its reference
imports."""

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.models import xtransformer, xtransformer_reference, xtransformer_work
from portbench.tests import conftest

CPU = torch.device("cpu")
TINY_BERT = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128, vocab_size=300,
                 max_position_embeddings=32, type_vocab_size=2, layer_norm_eps=1e-12, hidden_act="gelu",
                 initializer_range=0.02, pad_token_id=0)
# the tiny tree's levels are 4, 16, 64, 256 leaf clusters, 3,000 labels: the matcher's head is over the leaf clusters
CONFIG = dict(conftest.TINY_CONFIG, name="tinytext", model="xtransformer", encoder_type="bert", model_config=TINY_BERT,
              truncate_length=16, encoder_batch=256, max_match_clusters=256)
MIX = dict(conftest.TINY_BATCH, pool=256, block=64, batch_size=64,
           text_words={"law": "lognormal", "median": 10, "sigma": 1.0, "min": 2, "max": 40})
CELL = "tinytext-batch"
SEED = 2**31 + 77


@pytest.fixture
def xt_root(tmp_path):
    """A checkout root with a tiny XR-Transformer configuration and cell,
    which the new cell's metrics read in too."""
    root = conftest.make_tiny_root(tmp_path)
    dst = os.path.join(root, "portbench")
    conftest.write_json(os.path.join(dst, "configs", "tinytext.json"), CONFIG)
    conftest.write_json(os.path.join(dst, "traffic", CELL + ".json"), MIX)
    conftest.write_json(os.path.join(dst, "cells", CELL + ".json"), {"limits": conftest.LIMITS})
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tinytext", "source": "test", "file": "portbench/configs/tinytext.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "tinytext", "traffic": CELL, "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "xtransformer-wiki500k-batch" in m.get("workloads", []):
            m["workloads"].append(CELL)
    conftest.write_json(path, bench)
    return root


def run(root, trace=False, seconds=1.0):
    lines = []
    res = harness.run_cell(CELL, SEED, seconds, trace, CPU, time.perf_counter(), root=root, log=lines.append)
    return res, lines


def test_a_sound_run_is_correct(xt_root):
    res, lines = run(xt_root)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["checks"]["value_err"]["value"] < 1e-5
    assert set(res["metrics"]) == {"qps", "setup_s"}
    assert any(s.startswith("pool: 256 queries") and " digest " in s for s in lines)


def test_a_traced_run_reads_the_encoder_spans_and_counters(xt_root):
    """Off the card: the four readers of spans and counters read; the
    encoder's roofline (no device time) and the trace's share do not."""
    res, _ = run(xt_root, trace=True)
    assert res["correct"], res["checks"]
    got = set(res["metrics"])
    assert {"tokenize_ms.textbatch", "encode_ms.textbatch", "concat_ms.textbatch", "token_pad_share.textbatch"} <= got
    assert not got & {"encoder_roofline.textbatch", "mfu.textbatch"}
    assert 0.0 < res["metrics"]["token_pad_share.textbatch"]["value"] < 100.0


def test_an_encoder_serving_the_first_texts_embedding_is_not_correct(xt_root, monkeypatch):
    from pecos_tpu_torch.xmc.xtransformer import network

    encode = network.encode_batches

    def first_only(encoder, toks, device, batch_size=256):
        emb = encode(encoder, toks, device, batch_size)
        return emb[:1].expand_as(emb).contiguous()

    monkeypatch.setattr(network, "encode_batches", first_only)
    res, _ = run(xt_root)
    assert not res["correct"], res["checks"]
    assert res["checks"]["value_err"]["value"] > 1e-3


def test_an_encoder_in_bfloat16_is_not_correct(xt_root, monkeypatch):
    from pecos_tpu_torch.xmc.xtransformer import network

    encode = network.encode_batches

    def in_bfloat16(encoder, toks, device, batch_size=256):
        return encode(copy.deepcopy(encoder).to(torch.bfloat16), toks, device, batch_size).float()

    monkeypatch.setattr(network, "encode_batches", in_bfloat16)
    res, _ = run(xt_root)
    assert not res["correct"], res["checks"]
    assert res["checks"]["value_err"]["value"] > 1e-4


def test_the_pool_slices_and_stacks_as_a_whole(xt_root):
    cell = harness.Cell(CELL, xt_root)
    model = xtransformer.Model(cell.cfg, 7, CPU)
    Q = xtransformer.queries(model, 40, np.full(40, 12), cell.mix, 7, CPU)
    again = xtransformer.stack([Q[0:13], Q[13:14], Q[14:40]])
    assert harness.digest(xtransformer.arrays(again)) == harness.digest(xtransformer.arrays(Q))
    assert Q[13:14].shape[0] == 1 and xtransformer.row_sizes(Q[13:14])[0] == 12 + len(Q.texts[13].split())
    assert model.D == CONFIG["nr_features"] + TINY_BERT["hidden_size"]
    assert len(model.vocab) == TINY_BERT["vocab_size"] == len(set(model.vocab))
    assert model.head.nr_labels == 256
    # every node: its sparse weights, the H dense columns, then the bias at D + H
    H, D = TINY_BERT["hidden_size"], CONFIG["nr_features"]
    for ids in model.ids:
        assert ids.shape[1] == CONFIG["weights_per_label"] + H
        assert (ids[:, -H - 1 : -1] == np.arange(D, D + H)).all() and (ids[:, -1] == D + H).all()


def test_the_text_lengths_follow_the_mix():
    counts = xtransformer.word_counts(16384, {"law": "lognormal", "median": 300, "sigma": 1.0, "min": 8, "max": 4096}, 3)
    assert np.median(counts) == 300 and counts.min() >= 8 and counts.max() <= 4096
    assert 0.18 < np.mean(counts <= 126) < 0.21


def test_the_work_counts_the_encoder_and_the_concatenated_rows(xt_root):
    cell = harness.Cell(CELL, xt_root)
    model = xtransformer.Model(cell.cfg, 7, CPU)
    Q = xtransformer.queries(model, 32, np.full(32, 10), cell.mix, 7, CPU)
    ref = xtransformer_reference.build(model, cell.cfg, CPU)
    peaks = {"hbm_bytes_per_s": 1e12, "fp32_flop_per_s": 1e12}
    got = xtransformer_work.traced(ref, model, [Q[0:16], Q[16:32]], cell.cfg, peaks)
    per_text = xtransformer_work.encoder_flops(TINY_BERT, 16)
    assert got["encoder"]["texts"] == 32 and got["encoder"]["ops"] == 32 * per_text
    assert got["predict"]["seconds"] == pytest.approx(got["ranker"]["seconds"] + 32 * per_text / 1e12)
    assert got["k1"]["calls"] == 2 * sum(xtransformer_work.k1_levels(model.D, model.sizes))
    # the ranker reads 8 bytes a query nonzero: 10 TF-IDF ones and H embedding columns
    beams = ref.beam_search(Q, keep_beams=True)["beams"]
    children = [c.numpy() for c in ref.children]
    real = [(v != 0).sum(axis=1) for v in model.vals]
    batches = [(np.full(16, 10 + TINY_BERT["hidden_size"]), [b[s : s + 16] for b in beams]) for s in (0, 16)]
    want = xtransformer_work.traced_work(batches, children, real, xtransformer_work.k1_levels(model.D, model.sizes),
                                         CONFIG["only_topk"], peaks)
    assert got["ranker"] == want["predict"] and got["k1"] == want["k1"]


def test_bert_base_operations_a_text():
    """12 x (4 x 768^2 + 2 x 768 x 3,072 + 2 x 128 x 768) multiply-adds a
    token slot over 128 slots, and the pooler: ~22.35 GFLOP a text."""
    with open(os.path.join(conftest.BENCH_DIR, "configs", "xtransformer-wiki500k.json")) as f:
        cfg = json.load(f)
    ops = xtransformer_work.encoder_flops(cfg["model_config"], cfg["truncate_length"])
    assert ops == 2 * (128 * 12 * (4 * 768**2 + 2 * 768 * 3072 + 2 * 128 * 768) + 768**2)
    assert 22.3e9 < ops < 22.4e9


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import portbench.models.xtransformer_reference, "
            "portbench.models.xtransformer_work; print(sorted({m.split('.')[0] for m in sys.modules}))"
            % os.path.dirname(conftest.BENCH_DIR))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    tops = set(eval(out.stdout))
    assert not tops & {"pecos_tpu_torch", "transformers", "tokenizers", "jax", "jaxlib", "flax", "pecos_tpu"}


@pytest.mark.card
def test_the_tiny_cell_on_the_card(card, xt_root):
    """On the card: the sound traced run is correct and reads all six of the
    kind's metrics, the encoder's time from its CUDA events; the control is
    not correct."""
    from pecos_tpu_torch.utils import profile_util

    profile_util.reset()
    sound = harness.run_cell(CELL, SEED, 1.0, True, card, time.perf_counter(), root=xt_root, log=lambda s: None)
    assert sound["correct"], sound["checks"]
    assert profile_util.snapshot()["counters"]["pecos.encode.device_us"] > 0
    assert {"tokenize_ms.textbatch", "encode_ms.textbatch", "concat_ms.textbatch", "token_pad_share.textbatch",
            "encoder_roofline.textbatch", "mfu.textbatch"} <= set(sound["metrics"])
    control = harness.run_cell(CELL, SEED, 1.0, False, card, time.perf_counter(), root=xt_root,
                               log=lambda s: None, wire="float16")
    assert not control["correct"]
