"""The comparison that decides ``correct`` has to fail: for the control (the
port's float16 query wire in the float32 program's place) and for each fault
a serving cell can have, planted underneath the timed path of a whole run.

A fault that one chip cannot have (an exchange between chips left out) has
no case: every cell runs on one card."""

import time

import numpy as np
import pytest
import scipy.sparse as smat
import torch

from pecos_tpu_torch.xmc import inference
from portbench import harness

CPU = torch.device("cpu")
CELLS = ["tiny-batch", "tiny-online"]


def run(root, cell, **kw):
    return harness.run_cell(cell, 2**31 + 5, 1.5, False, CPU, time.perf_counter(), root=root, log=lambda s: None, **kw)


def failing(res):
    return sorted(k for k, c in res["checks"].items() if c["value"] > c["limit"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(tiny_root, cell):
    res = run(tiny_root, cell, wire="float16")
    assert not res["correct"] and "value_err" in failing(res)


def _stale(monkeypatch):
    """A step that returns its state unchanged: every call answers with the
    first answer it gave."""
    for cls in (inference.CompiledHierModel, inference.RealtimeSession):
        orig = cls.predict
        first = {}

        def predict(self, X, *a, _orig=orig, _first=first, **kw):
            out = _orig(self, X, *a, **kw)
            if out.shape[0] not in _first:
                _first[out.shape[0]] = out
            return _first[out.shape[0]]

        monkeypatch.setattr(cls, "predict", predict)


def _half_batch(monkeypatch):
    """Half of each batch left out: its rows come back with no labels."""
    orig = inference.CompiledHierModel.predict_padded

    def predict_padded(self, ids, vals, **kw):
        labels, scores = orig(self, ids, vals, **kw)
        half = (ids.shape[0] + 1) // 2
        labels = labels.clone()
        labels[half:] = -1
        return labels, scores

    monkeypatch.setattr(inference.CompiledHierModel, "predict_padded", predict_padded)


def _altered(monkeypatch):
    """An answer altered where it is produced: each row's best label is
    swapped for the next label id."""
    orig = inference.select_beam

    def select_beam(raw, cand, valid, pvals, k, pp, no_prev):
        labels, vals = orig(raw, cand, valid, pvals, k, pp, no_prev)
        if k == 20:  # the label level
            labels = labels.clone()
            labels[:, 0] = (labels[:, 0] + 1) % 3000
        return labels, vals

    monkeypatch.setattr(inference, "select_beam", select_beam)


FAULTS = {"stale": _stale, "half_batch": _half_batch, "altered": _altered}
# the online cell's batch is one query: it has no half to leave out
CASES = [(c, f) for c in CELLS for f in sorted(FAULTS) if not (f == "half_batch" and c == "tiny-online")]


@pytest.mark.parametrize("cell, fault", CASES)
def test_fault_fails(tiny_root, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    res = run(tiny_root, cell)
    assert not res["correct"], res["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cells_on_the_card(card, tiny_root, cell):
    """On the card (K1's CUDA kernel): the sound run is correct, the control is not."""
    sound = harness.run_cell(cell, 17, 1.0, True, card, time.perf_counter(), root=tiny_root, log=lambda s: None)
    assert sound["correct"], sound["checks"]
    control = harness.run_cell(cell, 17, 1.0, False, card, time.perf_counter(), root=tiny_root,
                               log=lambda s: None, wire="float16")
    assert not control["correct"]
