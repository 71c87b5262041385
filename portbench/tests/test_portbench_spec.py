"""BENCHMARK.json and the files it names, the result line's format, what the
benchmark imports, and a configuration, mix and metric added as new files."""

import ast
import json
import os
import re
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_names_units(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"] and bench["command"] == ["python3", "portbench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"] == []
    configs = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(BENCH_DIR, "traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(BENCH_DIR, "cells", w["name"] + ".json"))
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        assert all(w in e2e[m["moves"]].get("workloads", cells) for w in m["workloads"])
        assert os.path.exists(os.path.join(BENCH_DIR, "metrics", m["name"] + ".py"))
    for cell in cells:
        assert any(cell in m["workloads"] for m in bench["per_layer"])
        assert sum(cell in m.get("workloads", cells) for m in bench["end_to_end"]) >= 2
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_file_is_named_from_name_characters():
    for dirpath, dirnames, files in os.walk(BENCH_DIR):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__", "_cache")]
        for f in files + dirnames:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            if "__pycache__" not in rel:
                assert all(NAME.match(part) for part in rel.split("/")), rel


def test_result_line_format(tiny_root):
    res = harness.run_cell("tiny-batch", 99, 0.5, False, CPU, time.perf_counter(), root=tiny_root, log=lambda s: None)
    line = json.dumps(res)
    back = json.loads(line)
    assert list(back)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(back)[-1] == "checks"
    assert set(back["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for c in back["checks"].values():
        assert set(c) == {"value", "limit"}
    for m in back["metrics"].values():
        assert set(m) == {"value", "unit"}


def test_new_config_mix_and_metric_are_found_by_name(tiny_root):
    """tiny_root's configuration and mixes are new files; add a metric too."""
    bench_path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["per_layer"].append({"name": "traced_batches.extra", "unit": "batches", "better": "higher",
                               "source": "program_counter", "layer": "Batch pipeline (host)", "moves": "qps",
                               "workloads": ["tiny-batch"]})
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    with open(os.path.join(tiny_root, "portbench", "metrics", "traced_batches.extra.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx['batches'] or None\n")
    res = harness.run_cell("tiny-batch", 5, 0.5, True, CPU, time.perf_counter(), root=tiny_root, log=lambda s: None)
    assert res["metrics"]["traced_batches.extra"] == {"value": 2.0, "unit": "batches"}  # 2 calls of 1 batch
    assert res["correct"]


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, os.path.join(BENCH_DIR, "run.py"), "--workload", "wiki500k-batch",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


FORBIDDEN = {"jax", "jaxlib", "flax", "pecos_tpu", "scripts", "bench", "chip_smoke"}


def test_sources_import_nothing_forbidden_and_read_nothing_outside():
    for dirpath, _, files in os.walk(BENCH_DIR):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                src = fh.read()
            for node in ast.walk(ast.parse(src)):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                    names = [node.module]
                for n in names:
                    assert n.split(".")[0] not in FORBIDDEN, (path, n)
            if "tests" not in dirpath:
                for word in ("benchmarks/", "bench.py", "BASELINE.json", "scripts/"):
                    assert word not in src, (path, word)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import portbench.models.xrlinear_reference, portbench.models.xrlinear_work; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    tops = set(eval(out.stdout))
    assert "pecos_tpu_torch" not in tops and not tops & {"jax", "jaxlib", "flax", "pecos_tpu"}


def test_a_whole_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    code = f"""
import sys, time, json
sys.path.insert(0, {ROOT!r}); sys.path.insert(0, {os.path.join(BENCH_DIR, 'tests')!r})
import torch, conftest
from pathlib import Path
from portbench import harness
harness.set_environment()
root = conftest.make_tiny_root(Path({str(tmp_path)!r}))
res = harness.run_cell("tiny-online", 3, 0.3, True, torch.device("cpu"), time.perf_counter(), root=root, log=lambda s: None)
tops = sorted({{m.split('.')[0] for m in sys.modules}})
print(json.dumps({{"correct": res["correct"], "tops": tops, "forbidden": harness.forbidden_modules()}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] and got["forbidden"] == []
    assert "pecos_tpu_torch" in got["tops"]
    assert not set(got["tops"]) & {"jax", "jaxlib", "flax", "pecos_tpu"}
