"""A model kind brings its own queries, reference and work count: a toy
text-in kind (``toytext.py`` beside this file, registered as
``portbench.models.toytext``) runs whole cells through ``harness.run_cell``
using only what ``portbench/README.md``'s contract lists."""

import importlib
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests import conftest, toytext

CPU = torch.device("cpu")
CONFIG = dict(conftest.TINY_CONFIG, name="toytext", model="toytext", vocab=500, embed_dim=16)
MIX = dict(conftest.TINY_BATCH, pool=512, text_lengths={"min": 4, "max": 64})
CELL = "toytext-batch"


@pytest.fixture
def toy_root(tmp_path, monkeypatch):
    """A checkout root with a toytext configuration and cell, and the toy
    kind's three modules registered under ``portbench.models``."""
    for part in ("", "_reference", "_work"):
        monkeypatch.setitem(sys.modules, f"portbench.models.toytext{part}",
                            importlib.import_module(f"portbench.tests.toytext{part}"))
    root = conftest.make_tiny_root(tmp_path)
    dst = os.path.join(root, "portbench")
    conftest.write_json(os.path.join(dst, "configs", "toytext.json"), CONFIG)
    conftest.write_json(os.path.join(dst, "traffic", CELL + ".json"), MIX)
    conftest.write_json(os.path.join(dst, "cells", CELL + ".json"), {"limits": conftest.LIMITS})
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "toytext", "source": "test", "file": "portbench/configs/toytext.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "toytext", "traffic": CELL, "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "tiny-batch" in m.get("workloads", []):
            m["workloads"].append(CELL)
    conftest.write_json(path, bench)
    return root


def run(root, seconds=1.0):
    lines = []
    res = harness.run_cell(CELL, 2**31 + 23, seconds, False, CPU, time.perf_counter(), root=root, log=lines.append)
    return res, lines


def test_a_sound_text_in_run_is_correct(toy_root):
    res, lines = run(toy_root)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["checks"]["value_err"]["value"] < 1e-5
    assert set(res["metrics"]) == {"qps", "setup_s"}
    assert any(s.startswith("pool: 512 queries") and " digest " in s for s in lines)


def test_a_program_that_drops_the_embedding_is_not_correct(toy_root, monkeypatch):
    """The ranker is handed zeros in the H embedding columns."""
    features = toytext.Program.features

    def without_embedding(self, Q):
        X = features(self, Q).tolil()
        X[:, Q.X.shape[1]:] = 0
        return X.tocsr()

    monkeypatch.setattr(toytext.Program, "features", without_embedding)
    res, _ = run(toy_root)
    assert not res["correct"], res["checks"]
    assert res["checks"]["value_err"]["value"] > 1e-3


def test_the_toy_pool_slices_and_stacks_as_a_whole(toy_root):
    cell = harness.Cell(CELL, toy_root)
    model = toytext.Model(cell.cfg, 7, CPU)
    lengths = np.full(40, 12)
    Q = toytext.queries(model, 40, lengths, cell.mix, 7, CPU)
    again = toytext.stack([Q[0:13], Q[13:14], Q[14:40]])
    assert harness.digest(toytext.arrays(again)) == harness.digest(toytext.arrays(Q))
    assert Q[13:14].shape[0] == 1 and toytext.row_sizes(Q[13:14])[0] == 12 + np.diff(Q.tok_ptr)[13]
    assert model.D == CONFIG["nr_features"] + CONFIG["embed_dim"]


def test_the_toy_work_counts_the_concatenated_rows(toy_root):
    """``traced`` over one batch: every query's row has its TF-IDF nonzeros
    and H embedding columns."""
    from portbench.tests import toytext_reference, toytext_work

    cell = harness.Cell(CELL, toy_root)
    model = toytext.Model(cell.cfg, 7, CPU)
    Q = toytext.queries(model, 32, np.full(32, 10), cell.mix, 7, CPU)
    ref = toytext_reference.build(model, cell.cfg, CPU)
    peaks = {"hbm_bytes_per_s": 1e12, "fp32_flop_per_s": 1e12}
    got = toytext_work.traced(ref, model, [Q[0:16], Q[16:32]], cell.cfg, peaks)
    assert got["batches"] == 2 and got["k1"]["calls"] == 2 * sum(toytext_work.k1_levels(model.D, model.sizes))
    # the same beams over rows of 10 + H nonzeros, and over rows of 10: the
    # whole predict reads 8 bytes a query nonzero
    beams = ref.beam_search(Q, keep_beams=True)["beams"]
    children = [c.numpy() for c in ref.children]
    real = [(v != 0).sum(axis=1) for v in model.vals]
    k1 = toytext_work.k1_levels(model.D, model.sizes)

    def work(nnz):
        batches = [(np.full(16, nnz), [b[s : s + 16] for b in beams]) for s in (0, 16)]
        return toytext_work.traced_work(batches, children, real, k1, CONFIG["only_topk"], peaks)

    assert got == work(10 + CONFIG["embed_dim"])
    assert got["predict"]["bytes"] - work(10)["predict"]["bytes"] == 8 * 32 * CONFIG["embed_dim"]

