"""Fixtures of the benchmark's tests: a throwaway checkout root holding a
BENCHMARK.json with tiny cells, beside copies of the benchmark's data files."""

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
sys.path.insert(0, os.path.dirname(BENCH_DIR))

TINY_CONFIG = {
    "name": "tiny", "model": "xrlinear", "source": "test", "nr_labels": 3000, "nr_features": 100000,
    "mean_query_nnz": 40, "nr_splits": 4, "max_leaf_size": 20, "weights_per_label": 16, "bias": 1.0,
    "beam_size": 10, "only_topk": 20, "post_processor": "l3-hinge", "dtype": "float32", "zipf_s": 1.0,
    "weight_std": 0.25, "bias_weight_std": 0.05, "compare_sample": 512, "reduced": [],
    "topic": {"features": 16, "node_slots": 8, "label_slots": 4, "query_share": 0.25, "weight_mean": 0.5,
              "weight_std": 0.25},
}
# the program splits a call of 256 queries into one batch of 256 (its default 1,024, cut to the call)
TINY_BATCH = {"loop": "closed", "pool": 1024, "block": 256, "batch_size": 256, "trace_calls": 2,
              "lengths": {"law": "lognormal", "sigma": 0.8, "min": 1, "max": 256}}
TINY_ONLINE = {"loop": "open", "batch_size": 1, "session_cap": 256,
               "warm_requests": 4, "trace_requests": 20, "gap_requests": 5, "drain_s": 30,
               "lengths": {"law": "lognormal", "sigma": 0.8, "min": 1, "max": 256}}
LIMITS = {"failed": 0, "missing": 0, "label_miss": 0, "value_err": 1e-5}
# the open loop's metrics, which BENCHMARK.json declares for no cell yet
OPEN_LOOP_METRICS = {
    "end_to_end": [
        {"name": "p50_ms", "unit": "ms", "better": "lower", "bound": 0.25, "source": "host_clock"},
        {"name": "p95_ms", "unit": "ms", "better": "lower", "bound": 0.25, "source": "host_clock"},
    ],
    "per_layer": [
        {"name": "service_ms.online", "unit": "ms/query", "better": "lower", "source": "host_clock",
         "layer": "Online session (host)", "moves": "p95_ms"},
        {"name": "launches.online", "unit": "launches/query", "better": "lower", "source": "device_trace",
         "layer": "Beam search (device)", "moves": "p95_ms"},
        {"name": "device_idle.online", "unit": "%", "better": "lower", "source": "device_trace",
         "layer": "Device", "moves": "p95_ms"},
    ],
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped where torch sees none")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def write_json(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


def make_tiny_root(tmp_path):
    """A checkout root whose BENCHMARK.json adds tiny cells (tiny-batch,
    tiny-online) to the real ones, with copies of portbench's data files."""
    root = tmp_path / "checkout"
    dst = root / os.path.basename(BENCH_DIR)
    for sub in ("configs", "traffic", "cells", "metrics"):
        shutil.copytree(os.path.join(BENCH_DIR, sub), dst / sub)
    shutil.copy(os.path.join(BENCH_DIR, "peaks.json"), dst / "peaks.json")
    with open(os.path.join(os.path.dirname(BENCH_DIR), "BENCHMARK.json")) as f:
        bench = json.load(f)
    write_json(str(dst / "configs" / "tiny.json"), TINY_CONFIG)
    write_json(str(dst / "traffic" / "tiny-batch.json"), TINY_BATCH)
    write_json(str(dst / "traffic" / "tiny-online.json"), TINY_ONLINE)
    write_json(str(dst / "cells" / "tiny-batch.json"), {"limits": LIMITS})
    write_json(str(dst / "cells" / "tiny-online.json"), {"traffic": {"rate_per_s": 100}, "limits": LIMITS})
    bench["configs"].append({"name": "tiny", "source": "test", "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "test"})
    for cell, mix in (("tiny-batch", "tiny-batch"), ("tiny-online", "tiny-online")):
        bench["workloads"].append({"name": cell, "config": "tiny", "traffic": mix, "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny-batch")
    for section, entries in OPEN_LOOP_METRICS.items():
        bench[section] += [dict(m, workloads=["tiny-online"]) for m in entries]
    write_json(str(root / "BENCHMARK.json"), bench)
    return str(root)
