"""The per-layer metrics of where the program pads its query batches:
``device_pad_share.batch`` and ``upload_mb.batch``, read from the program's
counters ``pecos.pad.device``, ``pecos.upload_bytes`` and ``pecos.batches``."""

import time

import numpy as np
import pytest
import torch

from pecos_tpu_torch.utils import profile_util
from portbench import harness
from portbench.models import xrlinear

NAMES = ("device_pad_share.batch", "upload_mb.batch")


@pytest.fixture(autouse=True)
def fresh_registry():
    profile_util.reset()
    yield
    profile_util.reset()


@pytest.mark.parametrize("name", NAMES)
def test_a_program_without_the_registry_reads_none(name, monkeypatch):
    monkeypatch.delattr(profile_util, "snapshot")
    assert harness.metric_reader(name)({}) is None


@pytest.mark.parametrize("name", NAMES)
def test_a_registry_without_the_counters_reads_none(name):
    assert harness.metric_reader(name)({}) is None
    # a program that counts its batches and nonzeros but not where it pads them
    profile_util.count("pecos.batches", 8)
    profile_util.count("pecos.query_nnz", 3000)
    assert harness.metric_reader(name)({}) is None


@pytest.mark.parametrize("name, device_batches, upload_bytes, value", [
    ("device_pad_share.batch", 8, 0, 100.0),
    ("device_pad_share.batch", 2, 0, 25.0),
    ("device_pad_share.batch", 0, 0, 0.0),
    ("upload_mb.batch", 8, 25_600_000, 3.2),
    ("upload_mb.batch", 0, 268_435_456, 33.554432),
])
def test_the_counters_read_as_shares_and_megabytes(name, device_batches, upload_bytes, value):
    profile_util.count("pecos.batches", 8)
    profile_util.count("pecos.pad.device", device_batches)
    profile_util.count("pecos.upload_bytes", upload_bytes)
    assert harness.metric_reader(name)({}) == pytest.approx(value, rel=1e-12)


def test_a_traced_run_reads_every_batch_padded_on_the_device(tiny_root, monkeypatch):
    """On the float32 wire every batch travels as its CSR slice: indptr int64,
    indices int32 and data float32, 8 bytes a row and a nonzero, and 8 more
    a batch."""
    calls = []
    predict = xrlinear.Program.predict

    def recording(self, X):
        batch = min(1024, 1 << (X.shape[0] - 1).bit_length())
        batches = -(-X.shape[0] // batch)
        calls.append((batches, 8 * (X.shape[0] + batches) + 8 * X.nnz))
        return predict(self, X)

    monkeypatch.setattr(xrlinear.Program, "predict", recording)
    res = harness.run_cell("tiny-batch", 2**31 + 31, 0.5, True, torch.device("cpu"), time.perf_counter(),
                           root=tiny_root, log=lambda s: None)
    assert res["correct"], res["checks"]
    batches, nbytes = np.array(calls).sum(axis=0)
    assert res["metrics"]["device_pad_share.batch"] == {"value": 100.0, "unit": "%"}
    assert res["metrics"]["upload_mb.batch"] == {"value": pytest.approx(1e-6 * nbytes / batches, rel=1e-12),
                                                 "unit": "MB/batch"}
