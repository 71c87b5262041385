"""The port's mesh (pecos_tpu_torch.parallel.mesh) against the JAX package's
on the same models and queries.

The JAX package runs on conftest's 8 virtual CPU devices; the port's mesh is
the CPU repeated 8 times, which gives the same (dp, lp) = (4, 2); meshes of
(1, 4) run too.  The toy model's bottom layer has 498 labels, which lp=4 pads
to 500; one toy has 62 parents there, so its clusters differ in size.  Labels must
be equal; values within rtol 1e-5 (float32 sums in another order).  On the
CPU, K1's plain version scores the sparse engine.
"""

import numpy as np
import pytest
import torch

from pecos_tpu.parallel import mesh as jax_mesh
from pecos_tpu.xmc.inference import CompiledHierModel as JaxCompiled
from pecos_tpu.xmc.solvers import solve_block as jax_solve_block
from pecos_tpu.xmc.xlinear.model import XLinearModel as JaxXLinear
from pecos_tpu_torch.parallel import dryrun, mesh
from pecos_tpu_torch.xmc import HierarchicalMLModel, MLModel
from pecos_tpu_torch.xmc.base import PredictOnlyHierModel
from pecos_tpu_torch.xmc.inference import CompiledHierModel, load_compiled_layers, save_compiled_layers
from pecos_tpu_torch.xmc.solvers import solve_block
from pecos_tpu_torch.xmc.xlinear import XLinearModel
from test_mesh_predict import _sparse_queries, _toy_model

CPU8 = ["cpu"] * 8
SOLVER_ATOL = 1e-3  # port vs JAX solvers (tests/test_torch_solvers.py's limit)


def _port_model(jax_model):
    return HierarchicalMLModel([MLModel(W=m.W, C=m.C, bias=m.bias, device="cpu") for m in jax_model.model_chain])


def _compiled(jax_model, layouts):
    """The same chain compiled by both packages with these layouts (None: each package's default)."""
    Ws, Cs = [m.W for m in jax_model.model_chain], [m.C for m in jax_model.model_chain]
    if layouts is None:
        return jax_model._get_compiled(), _port_model(jax_model)._get_compiled()
    return (
        JaxCompiled.from_host_chain(Ws, Cs, bias=1.0, layouts=layouts),
        CompiledHierModel.from_host_chain(Ws, Cs, bias=1.0, layouts=layouts, device="cpu"),
    )


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_same_csr(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, rtol=rtol, atol=atol)


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_shape_matches_jax(n):
    m = mesh.make_mesh(n, devices=CPU8)
    assert m.shape == dict(jax_mesh.make_mesh(n).shape)
    assert m.size == m.shape["dp"] * m.shape["lp"] and all(d == torch.device("cpu") for r in m.devices for d in r)


def test_make_mesh_rejects_bad_sizes():
    with pytest.raises(ValueError, match="devices asked for"):
        mesh.make_mesh(9, devices=CPU8)
    with pytest.raises(ValueError, match="dp=16"):
        mesh.make_mesh(8, dp=16, devices=CPU8)
    assert mesh.make_mesh(4, dp=1, devices=CPU8).shape == {"dp": 1, "lp": 4}


@pytest.mark.parametrize("force_plabel", [False, True])
def test_label_sharded_predict_matches_jax(force_plabel):
    """The dense engines: data-parallel and label-sharded predicts equal the
    JAX package's, and each other, with the bottom layer dense or plabel."""
    jm, X = _toy_model()
    jc, pc = _compiled(jm, ["dense", "dense", "plabel"] if force_plabel else None)
    jmesh, pmesh = jax_mesh.make_mesh(8), mesh.make_mesh(8, devices=CPU8)
    kw = dict(beam_size=4, only_topk=5)
    for jfn, pfn in ((jax_mesh.shard_chain_predict, mesh.shard_chain_predict),
                     (jax_mesh.shard_chain_predict_labels, mesh.shard_chain_predict_labels)):
        jl, jv = jfn(jmesh, jc, X, **kw)
        pl, pv = pfn(pmesh, pc, X, **kw)
        np.testing.assert_array_equal(_np(pl), np.asarray(jl))
        np.testing.assert_allclose(_np(pv), np.asarray(jv), rtol=1e-5)
    ref = mesh.shard_chain_predict(pmesh, pc, X, **kw)
    np.testing.assert_array_equal(_np(mesh.shard_chain_predict_labels(pmesh, pc, X, **kw)[0]), _np(ref[0]))


def test_label_sharded_placement():
    """Each shard holds 1/lp of the padded label columns (dense layers) or of
    the padded packed rows (plabel layers), on its own device, built once."""
    jm, _ = _toy_model()
    _, pc = _compiled(jm, ["dense", "dense", "plabel"])
    pmesh = mesh.make_mesh(8, devices=CPU8)
    lp = pmesh.shape["lp"]
    labels = mesh.mesh_layers(pc, pmesh, "labels")
    L = pc.layers[-1].nr_labels
    Lp = -(-L // lp) * lp
    for row in labels:
        for layers in row:
            assert layers[-1].packed.shape == (Lp // lp, pc.layers[-1].packed.shape[1])
            assert layers[0].W.shape == (pc.layers[0].W.shape[0], -(-pc.layers[0].nr_labels // lp))
            assert layers[-1].children.shape == pc.layers[-1].children.shape  # the whole children table
    assert mesh.mesh_layers(pc, pmesh, "labels") is labels  # reused, not rebuilt
    # lp=4: 498 labels pad to 500
    m4 = mesh.make_mesh(4, dp=1, devices=CPU8)
    blocks = [row[-1] for row in mesh.mesh_layers(pc, m4, "labels")[0]]
    assert [b.packed.shape[0] for b in blocks] == [125] * 4
    np.testing.assert_array_equal(torch.cat([b.packed for b in blocks])[:L].numpy(), pc.layers[-1].packed.numpy())
    assert int(torch.cat([b.packed for b in blocks])[L:].abs().sum()) == 0


def test_label_sharded_sparse_matches_jax_and_single_device():
    """The sparse engine (label blocks of packed rows through K1 by candidate
    id, row -1 for a candidate a shard does not own): the JAX package's
    predict_sharded and the port's single-device predict, with and without
    padded labels, with clusters of equal and of unequal sizes."""
    kw = dict(beam_size=4, only_topk=5)
    for L1, n in ((64, 8), (64, 4), (62, 4)):
        jm, _ = _toy_model(L1=L1)
        jc, pc = _compiled(jm, ["dense", "dense", "plabel"])
        Xq = _sparse_queries(24, pc.nr_features, nnz=6)
        pmesh, jmesh = mesh.make_mesh(n, dp=None if n == 8 else 1, devices=CPU8), jax_mesh.make_mesh(n, dp=None if n == 8 else 1)
        got = mesh.predict_sharded(pmesh, pc, Xq, **kw)
        _assert_same_csr(got, jax_mesh.predict_sharded(jmesh, jc, Xq, **kw))
        _assert_same_csr(got, pc.predict(Xq, **kw))
    assert mesh.mesh_layers(pc, pmesh, "labels")[0][0][-1].packed.shape[0] == 125  # 498 labels padded to 500
    # the engine itself, and batches that do not divide by dp (23 rows, batches of 8 over dp 4)
    pmesh = mesh.make_mesh(8, devices=CPU8)
    labels, _ = mesh.shard_chain_predict_labels_sparse(pmesh, pc, Xq, **kw)
    np.testing.assert_array_equal(_np(labels), np.asarray(jax_mesh.shard_chain_predict_labels_sparse(jax_mesh.make_mesh(8), jc, Xq, **kw)[0]))
    _assert_same_csr(mesh.predict_sharded(pmesh, pc, Xq[:23], batch_size=8, **kw), pc.predict(Xq[:23], **kw))
    with pytest.raises(ValueError, match="not divisible by dp"):
        mesh.shard_chain_predict_labels_sparse(pmesh, pc, Xq[:23], **kw)


def test_xlinear_predict_mesh_kwarg():
    """XLinearModel.predict(..., mesh=) on sparse and dense X equals the
    default predict and the JAX package's predict with its mesh."""
    jm, X = _toy_model()
    port, jax_model = XLinearModel(_port_model(jm)), JaxXLinear(jm)
    pmesh, jmesh = mesh.make_mesh(8, devices=CPU8), jax_mesh.make_mesh(8)
    Xq = _sparse_queries(16, X.shape[1], nnz=5)
    kw = dict(beam_size=4, only_topk=5)
    ref = port.predict(Xq, **kw)
    got = port.predict(Xq, mesh=pmesh, **kw)
    _assert_same_csr(got, ref)
    _assert_same_csr(got, jax_model.predict(Xq, mesh=jmesh, **kw))
    Xd = np.asarray(Xq.todense())
    got_d = port.predict(Xd, mesh=pmesh, **kw)
    _assert_same_csr(got_d, ref, rtol=1e-4, atol=1e-5)
    _assert_same_csr(got_d, jax_model.predict(Xd, mesh=jmesh, **kw))


def test_predict_only_mesh_kwarg(tmp_path):
    """A predict-only model shards through ``mesh=`` when its layers are
    resident, and a lazily loaded one, which streams its layers, is refused
    with a clear error."""
    jm, X = _toy_model()
    pc = _port_model(jm)._get_compiled()
    save_compiled_layers(pc.layers, pc.bias, pc.nr_features, str(tmp_path))
    pmesh, kw = mesh.make_mesh(8, devices=CPU8), dict(beam_size=4, only_topk=5)
    Xq = _sparse_queries(16, X.shape[1], nnz=5)
    eager = PredictOnlyHierModel(load_compiled_layers(str(tmp_path), device="cpu"))
    _assert_same_csr(eager.predict(Xq, mesh=pmesh, **kw), eager.predict(Xq, **kw))
    lazy = PredictOnlyHierModel(load_compiled_layers(str(tmp_path), lazy=True, device="cpu"))
    with pytest.raises(ValueError, match="resident model; MmapCompiledHierModel streams"):
        lazy.predict(Xq, mesh=pmesh, **kw)


@pytest.mark.parametrize("n_devices", [4, 8])
def test_shard_solve_block(n_devices):
    """The sharded Newton-CG solve against the JAX package's (the solvers'
    limit) and against the port's unsharded solve_block (the X^T G sum over
    dp row shards differs only in the order of float32 additions)."""
    pmesh = mesh.make_mesh(n_devices, devices=CPU8)
    dp, lp = pmesh.shape["dp"], pmesh.shape["lp"]
    rng = np.random.default_rng(5)
    N, D, Lb = 16 * dp, 12, 4 * lp
    X = rng.standard_normal((N, D)).astype(np.float32)
    X[:, -1] = 1.0
    y = np.where(rng.uniform(size=(N, Lb)) < 0.3, 1.0, -1.0).astype(np.float32)
    c = rng.uniform(0.5, 1.5, size=(N, Lb)).astype(np.float32)
    kw = dict(max_newton=3, cg_max=5)
    W = mesh.shard_solve_block(pmesh, X, y, c, **kw)
    assert W.shape == (D, Lb)
    want_jax = np.asarray(jax_mesh.shard_solve_block(jax_mesh.make_mesh(n_devices), X, y, c, **kw))
    np.testing.assert_allclose(W.numpy(), want_jax, atol=SOLVER_ATOL)
    np.testing.assert_allclose(W.numpy(), np.asarray(jax_solve_block(X, y, c, **kw)), atol=SOLVER_ATOL)
    want = solve_block(*(torch.from_numpy(a) for a in (X, y, c)), **kw)
    np.testing.assert_allclose(W.numpy(), want.numpy(), atol=1e-5)


@pytest.mark.parametrize("n_devices", [1, 4, 8])
def test_dryrun(n_devices):
    out = dryrun.dryrun(mesh.make_mesh(devices=["cpu"] * n_devices))
    lp = out["mesh"]["lp"]
    assert out["bottom_W"][1][1] * lp == out["bottom_W"][0][1]
    assert out["packed"][1][0] * lp == out["packed"][0][0]
