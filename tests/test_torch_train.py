"""XR-Linear training in the port against the JAX package (CPU).

Anchors of ``tests/test_mlmodel.py`` run through the port: the solution
against sklearn's LinearSVC on the same primal objective, Cp=2 equal to R=2,
and the bucketed (gathered) solver equal to the masked dense one.

Against the JAX package, both trainers run on one problem and one cluster
chain.  At the default solve (newton_eps 0.01, 20 Newton x 10 CG steps) a
label's stopping iteration flips with the packages' summation order and W
moves by up to ~0.1 on ill-conditioned toy layers (ROADMAP F5), so the
packages are compared with a tight solve (``TIGHT``: newton_eps 1e-6, 60 x 60
steps), where W agrees within atol 2e-3 and >= 98% of predicted (row, rank)
labels are equal (neighbours tied within the solve's tolerance may swap).  The golden test through the port keeps
``tests/test_golden.py``'s bars where they do not depend on bits: precision
within 0.02 of the golden run, and > 90% of rows with equal label sets once
the chain is the JAX package's (the port's own chain is drawn from torch's
generator, another tree, whose ranks past the first differ).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as smat
import torch

from pecos_tpu.xmc import HierarchicalMLModel as JaxHLM
from pecos_tpu.xmc import Indexer as JaxIndexer
from pecos_tpu.xmc import LabelEmbeddingFactory as JaxLEF
from pecos_tpu.xmc import MLModel as JaxMLModel
from pecos_tpu.xmc import MLProblem as JaxProblem
from pecos_tpu.xmc.xlinear import XLinearModel as JaxXLinear
from pecos_tpu_torch.utils import smat_util
from pecos_tpu_torch.utils.cluster_util import ClusterChain
from pecos_tpu_torch.xmc import HierarchicalMLModel, Indexer, LabelEmbeddingFactory, MLModel, MLProblem
from pecos_tpu_torch.xmc import base as port_base
from pecos_tpu_torch.xmc.xlinear import XLinearModel
from pecos_tpu_torch.xmc.xlinear import train as train_cli

REPO = Path(__file__).resolve().parents[1]
DATA = REPO / "tests" / "data"
TIGHT = dict(newton_eps=1e-6, max_newton_iter=60, cg_max_iter=60)


def _toy_problem(n=120, d=10, L=6, seed=0):
    """tests/test_mlmodel.py's problem: label i % L around a random center."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((L, d)) * 3
    X = np.zeros((n, d), np.float32)
    for i in range(n):
        X[i] = centers[i % L] + rng.standard_normal(d) * 0.3
    Y = smat.csr_matrix((np.ones(n, np.float32), (np.arange(n), np.arange(n) % L)), shape=(n, L))
    return smat.csr_matrix(X), Y


def _pairs_C(L):
    return smat.csc_matrix((np.ones(L, np.float32), (np.arange(L), np.arange(L) // 2)), shape=(L, L // 2))


def _golden_data():
    load = lambda name: smat_util.load_matrix(str(DATA / name))
    return (load("X.trn.npz").tocsr(), load("Y.trn.npz").tocsr(), load("X.tst.npz").tocsr(),
            load("Y.tst.npz").tocsr(), load("Yt_pred.golden.npz").tocsr(), np.load(DATA / "golden_prec.npy"))


@pytest.fixture(scope="module")
def golden():
    X, Y, Xt, Yt, P_golden, golden_prec = _golden_data()
    jchain = JaxIndexer.gen(JaxLEF.create(Y, X, method="pifa"), max_leaf_size=4, nr_splits=2, seed=11)
    return X, Y, Xt, Yt, P_golden, golden_prec, ClusterChain(jchain.chain)


def _label_sets_equal(P, Q):
    P, Q = P.tocsr(), Q.tocsr()
    return np.mean([set(P.indices[P.indptr[i]:P.indptr[i + 1]]) == set(Q.indices[Q.indptr[i]:Q.indptr[i + 1]]) for i in range(P.shape[0])])


def _assert_same_ranking(P, Q):
    """Rows of equal length; >= 98% of (row, rank) labels equal (two
    neighbours whose scores tie within the solve's tolerance may swap), and
    the scores of the equal ones within rtol 1e-3."""
    P, Q = smat_util.sorted_csr(P.tocsr()), smat_util.sorted_csr(Q.tocsr())
    np.testing.assert_array_equal(P.indptr, Q.indptr)
    same = P.indices == Q.indices
    assert same.mean() >= 0.98, same.mean()
    np.testing.assert_allclose(P.data[same], Q.data[same], rtol=1e-3, atol=1e-6)


# ---- anchors (tests/test_mlmodel.py through the port) -------------------------


@pytest.mark.parametrize("solver_type,loss,slack", [("L2R_L2LOSS_SVC_DUAL", "squared_hinge", 1.01), ("L2R_L1LOSS_SVC_DUAL", "hinge", 1.02)])
def test_solver_matches_sklearn(solver_type, loss, slack):
    """The primal objective reached is within 1% (squared hinge) or 2% (the
    smoothed L1 hinge, scored on the exact hinge) of sklearn's."""
    from sklearn.svm import LinearSVC

    X, Y = _toy_problem(n=80, d=6, L=2, seed=1 if loss == "squared_hinge" else 2)
    eps, iters = (1e-3, 50) if loss == "squared_hinge" else (1e-4, 100)
    tp = MLModel.TrainParams(threshold=0.0, bias=1.0, solver_type=solver_type, newton_eps=eps, max_newton_iter=iters)
    W = MLModel.train(MLProblem(X, Y), train_params=tp, device="cpu").W.toarray()
    Xb = np.hstack([X.toarray(), np.ones((X.shape[0], 1), np.float32)])
    power = 2 if loss == "squared_hinge" else 1
    for l in range(2):
        y = np.where(Y[:, l].toarray().ravel() > 0, 1.0, -1.0)
        sk = LinearSVC(loss=loss, C=1.0, fit_intercept=False, tol=1e-6, max_iter=200000).fit(Xb, y)
        obj = lambda w: 0.5 * w @ w + np.sum(np.maximum(1 - y * (Xb @ w), 0) ** power)
        assert obj(W[:, l]) <= obj(sk.coef_.ravel()) * slack + 1e-4, (l, obj(W[:, l]), obj(sk.coef_.ravel()))


@pytest.mark.parametrize("mode", ["dense", "bucketed"])
def test_cost_sensitive_Cp_equals_R(mode):
    X, Y = _toy_problem(n=60, d=8, L=4, seed=2 if mode == "dense" else 10)
    C = None if mode == "dense" else _pairs_C(4)
    R = Y.tocsc() * 2.0
    tp = dict(threshold=0.0, solver_mode=mode, newton_eps=1e-4, max_newton_iter=50)
    m1 = MLModel.train(MLProblem(X, Y, C=C), train_params=MLModel.TrainParams(Cp=2.0, **tp), device="cpu")
    m2 = MLModel.train(MLProblem(X, Y, C=C, R=R), train_params=MLModel.TrainParams(Cp=1.0, **tp), device="cpu")
    np.testing.assert_allclose(m1.W.toarray(), m2.W.toarray(), rtol=1e-3, atol=1e-3)


def test_bucketed_matches_dense():
    X, Y = _toy_problem(n=120, d=10, L=8, seed=9)
    prob = MLProblem(X, Y, C=_pairs_C(8))
    tp = dict(threshold=0.0, newton_eps=1e-3, max_newton_iter=40)
    m_dense = MLModel.train(prob, train_params=MLModel.TrainParams(solver_mode="dense", **tp), device="cpu")
    m_buck = MLModel.train(prob, train_params=MLModel.TrainParams(solver_mode="bucketed", **tp), device="cpu")
    np.testing.assert_allclose(m_buck.W.toarray(), m_dense.W.toarray(), rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(
        m_buck.predict(X, only_topk=2).toarray(), m_dense.predict(X, only_topk=2).toarray(), rtol=1e-2, atol=1e-3
    )


def test_bucketed_big_cluster_path_matches_dense(monkeypatch):
    """Every cluster forced onto the global sparse-rows solver."""
    X, Y = _toy_problem(n=48, d=12, L=8, seed=5)
    prob = MLProblem(X, Y, C=_pairs_C(8))
    tp = dict(threshold=0.0, newton_eps=1e-4, max_newton_iter=50)
    m_dense = MLModel.train(prob, train_params=MLModel.TrainParams(solver_mode="dense", **tp), device="cpu")
    monkeypatch.setattr(port_base, "_LOCAL_DENSE_BUDGET", 1)
    m_big = MLModel.train(prob, train_params=MLModel.TrainParams(solver_mode="bucketed", **tp), device="cpu")
    assert np.allclose(m_dense.W.toarray(), m_big.W.toarray(), atol=5e-2), np.abs(m_dense.W - m_big.W).max()


# ---- MLModel / HierarchicalMLModel / XLinearModel against the JAX package ------


@pytest.mark.parametrize("mode,extra", [
    ("dense", {}),
    ("bucketed", {}),
    ("dense", dict(threshold=0.05, max_nonzeros_per_label=4, solver_type="L2R_LR_DUAL")),
    ("bucketed", dict(threshold=0.05, max_nonzeros_per_label=4, bias=-1.0)),
])
def test_mlmodel_train_matches_jax(mode, extra):
    X, Y = _toy_problem(n=120, d=10, L=8, seed=9)
    C = _pairs_C(8)
    M = smat.csc_matrix(np.random.default_rng(1).uniform(size=(120, 4)) < 0.4, dtype=np.float32)
    R = Y.tocsc() * 1.5
    kw = {"threshold": 0.0, "solver_mode": mode, **TIGHT, **extra}
    jm = JaxMLModel.train(JaxProblem(X, Y, C=C, M=M, R=R), train_params=JaxMLModel.TrainParams(**kw))
    pm = MLModel.train(MLProblem(X, Y, C=C, M=M, R=R), train_params=MLModel.TrainParams(**kw), device="cpu")
    assert pm.W.shape == jm.W.shape and pm.bias == jm.bias
    np.testing.assert_allclose(pm.W.toarray(), jm.W.toarray(), atol=2e-3, rtol=0)
    if "max_nonzeros_per_label" in extra:
        assert (np.diff(pm.W.tocsc().indptr) <= 4).all()


@pytest.mark.parametrize("scheme", ["tfn", "tfn+man", "usn", "usn+tfn+man"])
def test_hierarchical_train_matches_jax(golden, scheme):
    X, Y, Xt, _, _, _, chain = golden
    usn = None
    if "usn" in scheme:
        rng = np.random.default_rng(2)
        M0 = smat.csr_matrix(rng.uniform(size=Y.shape) < 0.1, dtype=np.float32)
        usn = chain.generate_matching_chain({0: M0})
    tp = dict(neg_mining_chain=scheme, model_chain=dict(threshold=0.0, **TIGHT))
    jm = JaxHLM.train(JaxProblem(X, Y), clustering=chain.chain, matching_chain=usn, train_params=tp)
    pm = HierarchicalMLModel.train(MLProblem(X, Y), clustering=chain, matching_chain=usn, train_params=tp, device="cpu")
    assert pm.depth == jm.depth == len(chain)
    for a, b in zip(pm.model_chain, jm.model_chain):
        np.testing.assert_allclose(a.W.toarray(), b.W.toarray(), atol=2e-3, rtol=0)
    _assert_same_ranking(pm.predict(Xt, beam_size=4, only_topk=5), jm.predict(Xt, beam_size=4, only_topk=5))


@pytest.mark.parametrize("mode,rel_mode,shallow", [
    ("full-model", "disable", False),
    ("full-model", "induce", False),
    ("full-model", "ranker-only", True),
    ("matcher", "disable", False),
    ("ranker", "induce", False),
])
def test_xlinear_train_modes_match_jax(golden, mode, rel_mode, shallow):
    X, Y, Xt, _, _, _, chain = golden
    R = Y.tocsc() * np.float32(1.5)
    kw = dict(mode=mode, rel_mode=rel_mode, shallow=shallow, threshold=0.0, ranker_level=2, **TIGHT)
    jm = JaxXLinear.train(X, Y, C=chain.chain, R=R, **kw)
    pm = XLinearModel.train(X, Y, C=chain, R=R, device="cpu", **kw)
    assert pm.model.depth == jm.model.depth
    assert [m.W.shape for m in pm.model.model_chain] == [m.W.shape for m in jm.model.model_chain]
    for a, b in zip(pm.model.model_chain, jm.model.model_chain):
        np.testing.assert_allclose(a.W.toarray(), b.W.toarray(), atol=2e-3, rtol=0)
    if mode != "ranker":  # a ranker alone predicts from its own top codes, not a beam from the root
        _assert_same_ranking(pm.predict(Xt, beam_size=4, only_topk=5), jm.predict(Xt, beam_size=4, only_topk=5))


def test_xlinear_train_errors():
    X, Y = _toy_problem(n=40, d=6, L=4)
    with pytest.raises(ValueError, match="rel_mode"):
        XLinearModel.train(X, Y, C=_pairs_C(4), rel_mode="sometimes", device="cpu")
    with pytest.raises(ValueError, match="matcher mode needs a clustering"):
        XLinearModel.train(X, Y, mode="matcher", device="cpu")
    with pytest.raises(ValueError, match="solver_mode"):
        XLinearModel.train(X, Y, solver_mode="sparse", device="cpu")
    if not torch.cuda.is_available():  # no fallback to the CPU when the card was asked for
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            XLinearModel.train(X, Y)
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            Indexer.gen(X.T.tocsr(), max_leaf_size=2)


# ---- the golden test through the port ----------------------------------------


def test_golden_through_port(golden):
    """The whole path in the port, its own PIFA and chain included, at the
    golden precision (atol 0.02); its top-1 label matches the golden run's on
    > 90% of rows.  With the JAX package's chain, > 90% of rows carry the
    golden label sets at the default solve's top 3 (83% at top 5: the
    fifth labels score below 1e-3 and move with the stopping step), and 100%
    at top 5 against the JAX trainer when both solve tightly."""
    X, Y, Xt, Yt, P_golden, golden_prec, jchain = golden
    chain = Indexer.gen(LabelEmbeddingFactory.create(Y, X, method="pifa"), max_leaf_size=4, nr_splits=2, seed=11, device="cpu")
    assert [C.shape for C in chain] == [C.shape for C in jchain]
    P = XLinearModel.train(X, Y, C=chain, threshold=0.0, device="cpu").predict(Xt, beam_size=8, only_topk=5)
    np.testing.assert_allclose(smat_util.Metrics.generate(Yt, P, topk=5).prec, golden_prec, atol=0.02)
    top1 = lambda A: smat_util.sorted_csr(A.tocsr(), only_topk=1)
    assert _label_sets_equal(top1(P), top1(P_golden)) > 0.9

    P = XLinearModel.train(X, Y, C=jchain, threshold=0.0, device="cpu").predict(Xt, beam_size=8, only_topk=5)
    np.testing.assert_allclose(smat_util.Metrics.generate(Yt, P, topk=5).prec, golden_prec, atol=0.02)
    top3 = lambda A: smat_util.sorted_csr(A.tocsr(), only_topk=3)
    assert _label_sets_equal(top3(P), top3(P_golden)) > 0.9

    P = XLinearModel.train(X, Y, C=jchain, threshold=0.0, device="cpu", **TIGHT).predict(Xt, beam_size=8, only_topk=5)
    P_jax = JaxXLinear.train(X, Y, C=jchain.chain, threshold=0.0, **TIGHT).predict(Xt, beam_size=8, only_topk=5)
    assert _label_sets_equal(P, P_jax) > 0.9
    np.testing.assert_allclose(smat_util.Metrics.generate(Yt, P, topk=5).prec, golden_prec, atol=0.02)


def test_port_trained_folder_predicts_in_jax(golden, tmp_path):
    """A model the port trains and saves loads in the JAX package and
    predicts the same labels, in the same order, as the port."""
    X, Y, Xt, _, _, _, chain = golden
    pm = XLinearModel.train(X, Y, C=chain, threshold=0.1, device="cpu")
    pm.save(str(tmp_path / "model"))
    jm = JaxXLinear.load(str(tmp_path / "model"))
    kw = dict(beam_size=4, only_topk=5)
    P_port, P_jax = pm.predict(Xt, **kw), jm.predict(Xt, **kw)
    np.testing.assert_array_equal(P_port.indptr, P_jax.indptr)
    np.testing.assert_array_equal(P_port.indices, P_jax.indices)
    np.testing.assert_allclose(P_port.data, P_jax.data, rtol=1e-5, atol=1e-7)


# ---- the train CLI -------------------------------------------------------------


def test_train_cli_end_to_end(golden, tmp_path):
    """The CLI with --device cpu from npz files: with its own indexer, then
    with a saved chain folder and a JAX-written params skeleton (F6)."""
    X, Y, Xt, Yt, _, golden_prec, chain = golden
    paths = {name: str(tmp_path / f"{name}.npz") for name in ("X", "Y")}
    smat_util.save_matrix(paths["X"], X)
    smat_util.save_matrix(paths["Y"], Y)
    train_cli.main(["-x", paths["X"], "-y", paths["Y"], "-m", str(tmp_path / "m1"), "--max-leaf-size", "4",
                    "--nr-splits", "2", "--seed", "11", "-t", "0.0", "--device", "cpu", "--verbose-level", "0"])
    P = XLinearModel.load(str(tmp_path / "m1"), device="cpu").predict(Xt, beam_size=8, only_topk=5)
    np.testing.assert_allclose(smat_util.Metrics.generate(Yt, P, topk=5).prec, golden_prec, atol=0.02)

    from pecos_tpu.xmc.xlinear.train import params_skeleton as jax_skeleton

    params = jax_skeleton()
    params["train_params"]["hlm_args"]["model_chain"][0]["threshold"] = 0.0
    params["train_params"]["hlm_args"]["model_chain"][0]["solver_type"] = "L2R_LR_DUAL"
    with open(tmp_path / "params.json", "w") as f:
        json.dump(params, f)
    chain.save(str(tmp_path / "chain"))
    train_cli.main(["-x", paths["X"], "-y", paths["Y"], "-m", str(tmp_path / "m2"), "-c", str(tmp_path / "chain"),
                    "--params-path", str(tmp_path / "params.json"), "--device", "cpu", "--verbose-level", "0"])
    pm = XLinearModel.load(str(tmp_path / "m2"), device="cpu")
    jm = JaxXLinear.train(X, Y, C=chain.chain, train_params=params["train_params"], pred_params=params["pred_params"])
    assert [m.W.shape for m in pm.model.model_chain] == [m.W.shape for m in jm.model.model_chain]
    m_port = smat_util.Metrics.generate(Yt, pm.predict(Xt, beam_size=8, only_topk=5), topk=5)
    m_jax = smat_util.Metrics.generate(Yt, jm.predict(Xt, beam_size=8, only_topk=5), topk=5)
    np.testing.assert_allclose(m_port.prec, m_jax.prec, atol=0.02)


def test_params_skeleton_and_jax_params_load(capsys):
    """--generate-params-skeleton prints the JAX package's skeleton with the
    port's class names, and both load into the port's classes."""
    from pecos_tpu.xmc.xlinear.train import params_skeleton as jax_skeleton

    train_cli.main(["--generate-params-skeleton"])
    port = json.loads(capsys.readouterr().out)
    jax_params = jax_skeleton()
    strip = lambda d: json.loads(json.dumps(d).replace('"pecos_tpu.', '"pecos_tpu_torch.'))
    assert port == strip(jax_params)
    for params in (port, jax_params):
        tp = XLinearModel.TrainParams.from_dict(params["train_params"])
        assert isinstance(tp.hlm_args, HierarchicalMLModel.TrainParams)
        mc = HierarchicalMLModel._broadcast_chain_params(tp.hlm_args, HierarchicalMLModel.TrainParams, 3).model_chain
        assert len(mc) == 3 and all(isinstance(p, MLModel.TrainParams) for p in mc)
        assert isinstance(XLinearModel.PredParams.from_dict(params["pred_params"]).hlm_args, HierarchicalMLModel.PredParams)
    with pytest.raises(ValueError, match="no counterpart"):
        MLModel.TrainParams.from_dict({"__meta__": {"class_fullname": "pecos_tpu.xmc.base###MLModel.NoSuchParams"}})
    with pytest.raises(ValueError, match="no module"):
        MLModel.TrainParams.from_dict({"__meta__": {"class_fullname": "pecos_tpu.no_such_module###MLModel.TrainParams"}})


def test_cli_requires_paths(capsys):
    with pytest.raises(SystemExit):
        train_cli.main(["-x", "X.npz"])
    assert "required" in capsys.readouterr().err
