"""The port stands without JAX: every module of pecos_tpu_torch, and
chip_smoke.py, import with jax blocked; params files and HNSW folders the JAX
package writes load without importing it (ROADMAP F6); nothing runs on a CUDA
path without a GPU or without nvcc."""

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

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import pecos_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pecos_tpu_torch.__path__, "pecos_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # the module only: main() runs under __main__
leaked = sorted(m for m in sys.modules if m == "pecos_tpu" or m.startswith("pecos_tpu."))
assert not leaked, leaked
print(len(names))
"""


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
    assert int(proc.stdout.strip()) >= 28  # every module of the package was walked, ann/ included


def test_train_modules_import_without_jax():
    proc = _run(["-c", _TRAIN_MODULES], cwd=REPO)
    assert proc.returncode == 0, proc.stderr


def test_ann_modules_import_without_jax():
    proc = _run(["-c", _ANN_MODULES], cwd=REPO)
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
