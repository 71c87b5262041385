"""The per-layer metrics read from the program's own spans and counters
(``pecos_tpu_torch.utils.profile_util``), on a tiny cell on the CPU."""

import time

import numpy as np
import pytest
import torch

from pecos_tpu_torch.utils import profile_util
from portbench import harness
from portbench.models import xrlinear

CPU = torch.device("cpu")
SPAN_METRICS = ("pad_ms.batch", "upload_ms.batch", "enqueue_ms.batch", "fetch_ms.batch", "layouts_s.batch")


def run(root, trace, seed=2**31 + 23):
    return harness.run_cell("tiny-batch", seed, 0.5, trace, CPU, time.perf_counter(), root=root, log=lambda s: None)


def test_a_traced_run_reports_the_program_span_metrics(tiny_root, monkeypatch):
    """pad_share.batch is the padding of every call the program served, from
    each call's queries: nonzeros against batches x rows x the call's cap."""
    calls = []
    predict = xrlinear.Program.predict

    def recording(self, X):
        nnz = np.diff(X.indptr)
        cap = max(64, 1 << (int(nnz.max()) - 1).bit_length())
        batch = min(1024, 1 << (X.shape[0] - 1).bit_length())
        calls.append((X.nnz, -(-X.shape[0] // batch) * batch * cap))
        return predict(self, X)

    monkeypatch.setattr(xrlinear.Program, "predict", recording)
    profile_util.reset()
    res = run(tiny_root, True)
    assert res["correct"], res["checks"]
    for name in SPAN_METRICS:
        assert res["metrics"][name]["value"] > 0, name
    nnz, slots = np.array(calls).sum(axis=0)
    assert res["metrics"]["pad_share.batch"] == {"value": pytest.approx(100.0 * (1 - nnz / slots), rel=1e-12),
                                                 "unit": "%"}
    assert 0 < res["metrics"]["pad_share.batch"]["value"] < 100
    assert res["metrics"]["layouts_s.batch"]["unit"] == "s"


def test_an_untraced_run_keeps_the_end_to_end_metrics_only(tiny_root):
    profile_util.reset()
    res = run(tiny_root, False)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"qps", "setup_s"}


@pytest.mark.parametrize("name", SPAN_METRICS + ("pad_share.batch",))
def test_a_program_without_the_registry_reads_none(name, monkeypatch):
    """The readers leave their metric out where the program keeps no
    registry, as before the program had one."""
    monkeypatch.delattr(profile_util, "snapshot")
    assert harness.metric_reader(name)({}) is None


@pytest.mark.parametrize("name", SPAN_METRICS + ("pad_share.batch",))
def test_a_registry_without_the_span_reads_none(name):
    profile_util.reset()
    assert harness.metric_reader(name)({}) is None
