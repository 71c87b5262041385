"""Whole runs of tiny cells on the CPU: the harness end to end, sound and
with the timed path broken underneath."""

import time

import numpy as np
import pytest
import torch

from portbench import harness

CPU = torch.device("cpu")


def run(root, cell, seed=2**31 + 11, seconds=1.0, trace=False, **kw):
    return harness.run_cell(cell, seed, seconds, trace, CPU, time.perf_counter(), root=root, log=lambda s: None, **kw)


@pytest.mark.parametrize("cell", ["tiny-batch", "tiny-online"])
def test_sound_run_is_correct(tiny_root, cell):
    res = run(tiny_root, cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    assert res["checks"]["value_err"]["value"] < 1e-5
    want = {"tiny-batch": {"qps", "setup_s"}, "tiny-online": {"p50_ms", "p95_ms", "setup_s"}}[cell]
    assert set(res["metrics"]) == want
    assert all(m["value"] > 0 for m in res["metrics"].values())


# Read from the harness before the model kinds took their queries, reference
# and work count out of it: a tiny-batch run of one call (a window of 0 s)
# at this seed, and the digest of its pool.
PIN_SEED = 2**31 + 101
PIN_DIGEST = "e56487cc92d78525fc37204b745a710731c1afec40151d02d89c7490a721e65c"
PIN_CHECKS = {"failed": 0, "missing": 0, "label_miss": 0, "value_err": 5.770265114858771e-07}


def test_the_tiny_cell_reads_as_pinned(tiny_root):
    """The same pool bit for bit, the same sampled answers compared with the
    same reference, the same numbers."""
    lines = []
    res = harness.run_cell("tiny-batch", PIN_SEED, 0.0, False, CPU, time.perf_counter(), root=tiny_root,
                           log=lines.append)
    assert res["attempted"] == 256 and res["correct"]
    assert {k: c["value"] for k, c in res["checks"].items()} == PIN_CHECKS
    assert any(s.startswith("pool: 1024 queries") and f"digest {PIN_DIGEST} " in s for s in lines), lines
    assert any(s.startswith("reference: 256 sampled answers compared (254 ") for s in lines), lines
