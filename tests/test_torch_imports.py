"""The port stands without JAX: every module of pecos_tpu_torch, and
chip_smoke.py, import with jax, sklearn, sentencepiece and transformers
blocked, as on the GPU machine, and the host core builds from the port's own
sources; params files and HNSW folders the JAX package writes load without
importing it (ROADMAP F6); nothing runs on a CUDA path without a GPU or
without nvcc, and a host core that does not compile raises."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pecos_tpu_torch.ops import _build
from pecos_tpu_torch.utils.torch_util import make_generator, resolve_device

REPO = Path(__file__).resolve().parents[1]

_BLOCKED = ("jax", "sklearn", "sentencepiece", "transformers")

_IMPORT_ALL = """
import importlib, os, pkgutil, sys
for blocked in %r:
    sys.modules[blocked] = None  # any import of it now raises ImportError
import pecos_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pecos_tpu_torch.__path__, "pecos_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("pecos_tpu_torch.core", "pecos_tpu_torch.apps.text2text.predict", "pecos_tpu_torch.utils.mmap_valstore_util",
             "pecos_tpu_torch.utils.featurization.text.sentencepiece_util", "pecos_tpu_torch.xmc.calibration"):
    assert name in names, name
import chip_smoke  # the module only: main() runs under __main__
leaked = sorted(m for m in sys.modules if m == "pecos_tpu" or m.startswith("pecos_tpu."))
assert not leaked, leaked
# the host core: built from pecos_tpu_torch/core/csrc, loaded from pecos_tpu_torch/_build
from pecos_tpu_torch import core
from pecos_tpu_torch.utils.featurization.text import Tfidf
assert Tfidf.train(["a b", "b c"]).predict(["a c"]).nnz == 2
assert all(os.path.dirname(s) == os.path.join(os.path.dirname(pecos_tpu_torch.__file__), "core", "csrc") for s in core._sources())
maps = open("/proc/self/maps").read()
assert core.LIB_PATH in maps and "libpecos_tpu_core.so" not in maps, core.LIB_PATH
print(len(names))
""" % (_BLOCKED,)


_TRAIN_MODULES = """
import sys
sys.modules["jax"] = None
import pecos_tpu_torch.xmc.solvers, pecos_tpu_torch.xmc.clustering, pecos_tpu_torch.xmc.xlinear.train
import pecos_tpu_torch.utils.cluster_util
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None and (m in ("jax", "pecos_tpu") or m.startswith(("jax.", "pecos_tpu."))))
assert not leaked, leaked
"""

# params written by the JAX package's train CLI load into the port's classes
# without importing the JAX package or jax (ROADMAP F6)
_LOAD_JAX_PARAMS = """
import json, sys
params = json.load(open(sys.argv[1]))
assert "pecos_tpu.xmc.xlinear.model###XLinearModel.TrainParams" in json.dumps(params)
from pecos_tpu_torch.xmc import HierarchicalMLModel, MLModel
from pecos_tpu_torch.xmc.clustering import HierarchicalKMeans
from pecos_tpu_torch.xmc.xlinear import XLinearModel
tp = XLinearModel.TrainParams.from_dict(params["train_params"])
pp = XLinearModel.PredParams.from_dict(params["pred_params"])
ip = HierarchicalKMeans.TrainParams.from_dict(params["indexer_params"])
assert isinstance(tp.hlm_args, HierarchicalMLModel.TrainParams) and isinstance(pp.hlm_args, HierarchicalMLModel.PredParams)
mc = HierarchicalMLModel._broadcast_chain_params(tp.hlm_args, HierarchicalMLModel.TrainParams, 2).model_chain
assert [type(p) for p in mc] == [MLModel.TrainParams] * 2, mc
assert ip.nr_splits == 16
leaked = sorted(m for m in sys.modules if m in ("jax", "pecos_tpu") or m.startswith(("jax.", "pecos_tpu.")))
assert not leaked, leaked
print("ok")
"""


_ANN_MODULES = """
import sys
sys.modules["jax"] = None
import pecos_tpu_torch.ann, pecos_tpu_torch.ann.hnsw.train, pecos_tpu_torch.ann.hnsw.predict, pecos_tpu_torch.ann.pairwise
from pecos_tpu_torch.ann import HNSW
from pecos_tpu_torch.ann.hnsw import HNSWProductQuantizer4Bits
from pecos_tpu_torch.ann.pairwise import PairwiseANN
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None and (m in ("jax", "pecos_tpu") or m.startswith(("jax.", "pecos_tpu."))))
assert not leaked, leaked
"""

_PARALLEL_MODULES = """
import sys
sys.modules["jax"] = None
import pecos_tpu_torch.parallel, pecos_tpu_torch.parallel.comm, pecos_tpu_torch.parallel.mesh, pecos_tpu_torch.parallel.dryrun
import pecos_tpu_torch.distributed, pecos_tpu_torch.distributed.diagnostic_tools, pecos_tpu_torch.distributed.diagnostic_tools.comm_check
import pecos_tpu_torch.distributed.xmc, pecos_tpu_torch.distributed.xmc.base
import pecos_tpu_torch.distributed.xmc.xlinear, pecos_tpu_torch.distributed.xmc.xlinear.model, pecos_tpu_torch.distributed.xmc.xlinear.train
from pecos_tpu_torch.parallel import DummyComm, make_mesh
from pecos_tpu_torch.distributed.xmc.xlinear import DistributedXLinearModel
assert make_mesh(4, devices=["cpu"] * 4).shape == {"dp": 2, "lp": 2}
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None and (m in ("jax", "pecos_tpu") or m.startswith(("jax.", "pecos_tpu."))))
assert not leaked, leaked
"""

# an HNSW folder the JAX package saved searches in the port without jax
_LOAD_JAX_HNSW = """
import sys
import numpy as np
sys.modules["jax"] = None
from pecos_tpu_torch.ann import HNSW
model = HNSW.load(sys.argv[1], device="cpu")
ids, dists = model.predict(np.load(sys.argv[2]), efS=20, topk=5)
assert (ids == np.load(sys.argv[3])).mean() >= 0.99, ids
assert "jax" not in sys.modules or sys.modules["jax"] is None
print("ok")
"""


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_port_imports_without_jax():
    proc = _run(["-c", _IMPORT_ALL], cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    # every module of the package was walked: ann/, parallel/, distributed/, core/, apps/ and featurization/ included
    assert int(proc.stdout.strip()) >= 59


def test_host_core_build_failure_raises(monkeypatch, tmp_path):
    """A source that does not compile raises with the compiler's output; no
    path falls back to the Python tokenizer."""
    from pecos_tpu_torch import core

    src = tmp_path / "csrc"
    src.mkdir()
    (src / "broken.cpp").write_text("int broken( { return 0; }\n")
    monkeypatch.setattr(core, "_CSRC_DIR", str(src))
    monkeypatch.setattr(core, "LIB_PATH", str(tmp_path / "build" / "lib.so"))
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*broken.cpp"):
        core.build()
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        core.build(force=True)


def test_build_rebuilds_for_another_compiler(tmp_path):
    """A library built by one compiler is current for it and built again
    when another compiler (another path or ``--version``) is found, as for a
    ``_build/`` copied from another machine."""
    from pecos_tpu_torch.utils.build_util import build_library

    src = tmp_path / "lib.cpp"
    src.write_text("int f() { return 1; }\n")
    lib = str(tmp_path / "build" / "lib.so")

    def fake_cc(name, version):
        cc = tmp_path / name
        cc.write_text(f'#!/bin/sh\n[ "$1" = --version ] && {{ echo fake cc {version}; exit 0; }}\n'
                      'while [ "$1" != -o ]; do shift; done; echo built > "$2"\n')
        cc.chmod(0o755)
        return lambda: str(cc)

    def built(find_cc):
        return build_library(find_cc, ["-O3"], [str(src)], lib) > 0

    assert built(fake_cc("cc", 1))
    assert not built(fake_cc("cc", 1))  # current
    assert built(fake_cc("cc", 2))  # the same path, another version
    assert built(fake_cc("other-cc", 2))  # another path
    assert not built(fake_cc("other-cc", 2))


def test_train_modules_import_without_jax():
    proc = _run(["-c", _TRAIN_MODULES], cwd=REPO)
    assert proc.returncode == 0, proc.stderr


def test_ann_modules_import_without_jax():
    proc = _run(["-c", _ANN_MODULES], cwd=REPO)
    assert proc.returncode == 0, proc.stderr


def test_parallel_and_distributed_modules_import_without_jax():
    proc = _run(["-c", _PARALLEL_MODULES], cwd=REPO)
    assert proc.returncode == 0, proc.stderr


def test_jax_hnsw_folder_loads_without_jax(tmp_path):
    import numpy as np

    from pecos_tpu.ann import HNSW as JaxHNSW

    rng = np.random.default_rng(0)
    X, Q = rng.standard_normal((120, 8)).astype(np.float32), rng.standard_normal((6, 8)).astype(np.float32)
    model = JaxHNSW.train(X, M=6, efC=20, metric_type="l2", max_level_upper_bound=2)
    model.save(str(tmp_path / "hnsw"))
    np.save(tmp_path / "Q.npy", Q)
    np.save(tmp_path / "ids.npy", model.predict(Q, efS=20, topk=5)[0])
    proc = _run(["-c", _LOAD_JAX_HNSW, str(tmp_path / "hnsw"), str(tmp_path / "Q.npy"), str(tmp_path / "ids.npy")], cwd=REPO)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_jax_params_skeleton_loads_without_jax(tmp_path):
    """F6: a skeleton written by ``python -m pecos_tpu.xmc.xlinear.train
    --generate-params-skeleton`` loads in a process that never imports jax."""
    skeleton = tmp_path / "params.json"
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "pecos_tpu.xmc.xlinear.train", "--generate-params-skeleton"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    skeleton.write_text(proc.stdout)
    proc = _run(["-c", _LOAD_JAX_PARAMS, str(skeleton)], cwd=REPO)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_chip_smoke_fails_without_gpu_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run")
    proc = _run(["chip_smoke.py"], cwd=REPO)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    # alone in a directory, without the package beside it
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(force=True)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            resolve_device("cuda")
    a = torch.rand(4, generator=make_generator(3))
    assert torch.equal(a, torch.rand(4, generator=make_generator(3)))
