"""Compiled predict-only folders across the two packages.

``compile_mmap_model`` / ``save_compiled_layers`` write one format in both
packages: the port loads the JAX package's folders and the JAX package loads
the port's, eagerly and as the streaming (lazy) model with every layer
streamed or some resident, and both predict the same labels.  Scores agree to
rtol=1e-5, atol=1e-7 (float32 sums in another order).
"""

import json
import os

import numpy as np
import pytest
import torch

from pecos_tpu.xmc import inference as jax_inf
from pecos_tpu.xmc.xlinear import XLinearModel as JaxXLinear
from pecos_tpu_torch.xmc import PredictOnlyHierModel
from pecos_tpu_torch.xmc.inference import (
    CompiledHierModel,
    MmapCompiledHierModel,
    load_compiled_layers,
    save_compiled_layers,
)
from pecos_tpu_torch.xmc.xlinear import XLinearModel
from test_torch_inference import _models, assert_same_predictions
from test_torch_xlinear import jax_model_folder  # noqa: F401 (fixture)

KW = dict(beam_size=3, only_topk=10)
# resident layers of the lazy model: none (budget 0), the first layer only
# (budget = its file's bytes), every layer of this small chain (1 MiB)
LOADS = {"eager": None, "lazy0": 0, "lazy_front": "layer_0", "lazy1MiB": 1 << 20}


@pytest.fixture(scope="module")
def chain_folders(tmp_path_factory):
    """A dense/plabel/plabel chain compiled by each package into its own folder."""
    jm, tm, X, _ = _models("scatter")
    root = tmp_path_factory.mktemp("compiled")
    jax_dir, port_dir = str(root / "jax"), str(root / "port")
    jax_inf.save_compiled_layers(jm.layers, jm.bias, jm.nr_features, jax_dir)
    save_compiled_layers(tm.layers, tm.bias, tm.nr_features, port_dir)
    return jm, X, jax_dir, port_dir


def test_folders_are_equal(chain_folders):
    _, _, jax_dir, port_dir = chain_folders
    with open(os.path.join(jax_dir, "compiled.json")) as f, open(os.path.join(port_dir, "compiled.json")) as g:
        assert json.load(f) == json.load(g)
    for d in range(3):
        with np.load(os.path.join(jax_dir, f"layer_{d}.npz")) as a, np.load(os.path.join(port_dir, f"layer_{d}.npz")) as b:
            assert sorted(a.files) == sorted(b.files)
            for name in a.files:
                assert a[name].dtype == b[name].dtype
                np.testing.assert_array_equal(a[name], b[name])


@pytest.mark.parametrize("load", list(LOADS))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_load_compiled_layers_matches_jax(chain_folders, writer, load):
    jm, X, jax_dir, port_dir = chain_folders
    folder = jax_dir if writer == "jax" else port_dir
    budget = LOADS[load]
    if budget is None:
        kw = dict(lazy=False)
    elif budget == "layer_0":
        kw = dict(lazy=True, resident_budget_bytes=os.path.getsize(os.path.join(folder, "layer_0.npz")))
    else:
        kw = dict(lazy=True, resident_budget_bytes=budget)
    port = load_compiled_layers(folder, device="cpu", **kw)
    want = jax_inf.load_compiled_layers(folder, **kw)
    assert isinstance(port, MmapCompiledHierModel if kw["lazy"] else CompiledHierModel)
    if kw["lazy"]:
        assert sorted(port._resident) == sorted(want._resident) == list(range({0: 0, "layer_0": 1}.get(budget, 3)))
    assert_same_predictions(want.predict(X, **KW), port.predict(X, **KW))


def test_lazy_agrees_with_eager(chain_folders):
    """Lazy scores dense queries by gather, eager by intersection: same labels."""
    _, X, _, port_dir = chain_folders
    eager = load_compiled_layers(port_dir, device="cpu").predict(X, **KW)
    lazy = load_compiled_layers(port_dir, lazy=True, resident_budget_bytes=0, device="cpu")
    assert_same_predictions(eager, lazy.predict(X, batch_size=64, **KW))
    with pytest.raises(ValueError, match="Feature dimension"):
        lazy.predict(X[:, :-1])


@pytest.fixture(scope="module")
def compiled_models(jax_model_folder, tmp_path_factory):  # noqa: F811
    folder, X, Y = jax_model_folder
    root = tmp_path_factory.mktemp("mmap")
    jax_out, port_out = str(root / "jax"), str(root / "port")
    JaxXLinear.compile_mmap_model(folder, jax_out)
    XLinearModel.compile_mmap_model(folder, port_out)
    return folder, X, jax_out, port_out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_predict_only_load_both_ways(compiled_models, writer):
    folder, X, jax_out, port_out = compiled_models
    out = jax_out if writer == "jax" else port_out
    port = XLinearModel.load(out, is_predict_only=True, device="cpu")
    assert isinstance(port.model, PredictOnlyHierModel) and port.device == torch.device("cpu")
    jm = JaxXLinear.load(out, is_predict_only=True)
    kw = dict(beam_size=4, only_topk=5)
    P = port.predict(X, **kw)
    assert_same_predictions(jm.predict(X, **kw), P)
    # and the same labels as the full model folder it was compiled from
    assert_same_predictions(XLinearModel.load(folder, device="cpu").predict(X, **kw), P)


def test_predict_only_surface(compiled_models):
    _, X, jax_out, _ = compiled_models
    port = XLinearModel.load(jax_out, is_predict_only=True, device="cpu")
    m = port.model
    assert (m.depth, m.nr_labels, m.nr_features) == (JaxXLinear.load(jax_out, is_predict_only=True).model.depth, 32, X.shape[1])
    with pytest.raises(ValueError, match="predict only"):
        m.save("unused")
    with pytest.raises(ValueError, match="predict only"):
        port.predict(X, csr_codes=X[:, :2])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.predict(X, mesh=object())
    # a session and the wire options run on the predict-only model too
    kw = dict(beam_size=4, only_topk=5)
    sess = port.realtime_session(batch=2, cap=16, **kw)
    assert_same_predictions(port.predict(X[:2], **kw), sess.predict(X[:2]))
    P16 = port.predict(X, wire_value_dtype="float16", **kw)
    assert_same_predictions(JaxXLinear.load(jax_out, is_predict_only=True).model._get_compiled().predict(
        X, wire_value_dtype="float16", **kw), P16)
    # without is_predict_only the compiled folder is not used (there is no ranker/)
    with pytest.raises(FileNotFoundError):
        XLinearModel.load(jax_out, device="cpu")
