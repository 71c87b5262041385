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
