"""Per-layer predict, selected-output scoring and model surgery: the port
against the JAX package on the same models.

Labels must be equal; scores agree to rtol=1e-5, atol=1e-7 (float32 sums in
another order, path values near zero).  Against the numpy reference
``predict_numpy`` and between the fused chain and the layer loop the JAX
package's own tolerance holds: rtol=2e-4, atol=2e-5 (tests/test_mlmodel.py,
tests/test_xlinear.py).
"""

import numpy as np
import pytest
import scipy.sparse as smat

from pecos_tpu.xmc import inference as jax_inf
from pecos_tpu.xmc.base import MLModel as JaxMLModel
from pecos_tpu.xmc.xlinear import XLinearModel as JaxXLinear
from pecos_tpu.xmc.xlinear import evaluate as jax_evaluate
from pecos_tpu_torch.utils import smat_util
from pecos_tpu_torch.xmc import MLModel
from pecos_tpu_torch.xmc.inference import build_device_layer, single_layer_predict
from pecos_tpu_torch.xmc.xlinear import XLinearModel
from pecos_tpu_torch.xmc.xlinear import evaluate as evaluate_cli
from test_torch_inference import assert_same_predictions, make_chain, make_queries
from test_torch_xlinear import jax_model_folder  # noqa: F401 (fixture)

PPS = ["noop", "sigmoid", "l3-hinge", "log-l1-hinge"]
# where every label of a small tree is ranked, the product post-processors'
# path values underflow; XLA on the CPU flushes subnormals to zero and torch
# does not, so such ties break differently.  The additive log form keeps the
# tail apart for the cross-package comparisons that rank every label.
LOG_PP = "log-l3-hinge"


def _assert_close_dense(A, B, rtol=2e-4, atol=2e-5):
    np.testing.assert_allclose(np.asarray(A.todense()), np.asarray(B.todense()), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def layer():
    """One layer of 64 labels under 8 codes over D=40 features, queries and a
    beam of 3 active codes per query with values in (0.5, 1)."""
    Ws, Cs = make_chain(40, [8, 64], 6, 40, seed=5)
    X = make_queries(30, 40, 12, 40, seed=6)
    rng = np.random.default_rng(7)
    codes = np.zeros((30, 8), np.float32)
    for i in range(30):
        codes[i, rng.choice(8, size=3, replace=False)] = rng.uniform(0.5, 1.0, size=3)
    return Ws[1], Cs[1], X, smat.csr_matrix(codes)


@pytest.mark.parametrize("pp", PPS)
@pytest.mark.parametrize("with_codes", [False, True])
def test_mlmodel_predict_matches_jax_and_numpy(layer, pp, with_codes):
    W, C, X, codes = layer
    codes = codes if with_codes else None
    port = MLModel(W, C, bias=1.0, device="cpu")
    jm = JaxMLModel(W, C, bias=1.0)
    P = port.predict(X, csr_codes=codes, only_topk=7, post_processor=pp)
    assert_same_predictions(jm.predict(X, csr_codes=codes, only_topk=7, post_processor=pp), P)
    _assert_close_dense(port.predict_numpy(X, csr_codes=codes, only_topk=7, post_processor=pp), P)
    np.testing.assert_array_equal(
        port.predict_numpy(X, csr_codes=codes, only_topk=7, post_processor=pp).indices,
        jm.predict_numpy(X, csr_codes=codes, only_topk=7, post_processor=pp).indices,
    )


@pytest.mark.parametrize("with_codes", [False, True])
def test_single_layer_predict_plabel_matches_jax(layer, with_codes):
    """A plabel layer: the JAX package scores dense queries by gather, the
    port the sparse queries through K1 (its plain version on the CPU)."""
    W, C, X, codes = layer
    codes = codes if with_codes else None
    port = single_layer_predict(build_device_layer(W, C, layout="plabel", device="cpu"), X, 1.0, codes, 9, "l3-hinge", batch_size=8)
    want = jax_inf.single_layer_predict(jax_inf.build_device_layer(W, C, layout="plabel"), X, 1.0, codes, 9, "l3-hinge")
    assert_same_predictions(want, port)


def test_mlmodel_predict_errors_and_astype(layer):
    W, C, X, codes = layer
    port = MLModel(W, C, bias=1.0, device="cpu")
    with pytest.raises(ValueError, match="Feature dimension"):
        port.predict(X[:, :-1])
    with pytest.raises(ValueError, match="not valid"):
        port.predict(X, post_processor="nope")
    P = port.predict(X[:0], csr_codes=codes[:0])
    assert P.shape == (0, 64) and P.nnz == 0
    cast = port.astype(np.float64)
    assert cast.W.dtype == np.float32 and cast.device == port.device
    assert_same_predictions(port.predict(X), cast.predict(X))


@pytest.mark.parametrize("with_codes", [False, True])
def test_mlmodel_selected_outputs_match_jax(layer, with_codes):
    W, C, X, codes = layer
    codes = codes if with_codes else None
    port = MLModel(W, C, bias=1.0, device="cpu")
    sel = port.predict(X, only_topk=5)  # a selection with ragged rows once codes restrict it
    sel = sel.multiply(sel > 0.3).tocsr()
    sel.eliminate_zeros()
    got = port.predict_on_selected_outputs(X, sel, csr_codes=codes)
    assert_same_predictions(JaxMLModel(W, C, bias=1.0).predict_on_selected_outputs(X, sel, csr_codes=codes), got)
    with pytest.raises(ValueError, match="Label dimension"):
        port.predict_on_selected_outputs(X, sel[:, :-1])


@pytest.mark.parametrize("reindex", [False, True])
def test_get_submodel_matches_jax(layer, reindex):
    W, C, _, _ = layer
    kw = dict(selected_codes=[1, 5], selected_labels=np.arange(0, 64, 2), reindex=reindex)
    got = MLModel(W, C, bias=1.0, device="cpu").get_submodel(**kw)
    want = JaxMLModel(W, C, bias=1.0).get_submodel(**kw)
    for key in ("active_labels", "active_codes"):
        np.testing.assert_array_equal(got[key], want[key])
    for name in ("W", "C"):
        a, b = getattr(got["model"], name), getattr(want["model"], name)
        assert a.shape == b.shape and (a != b).nnz == 0
    with pytest.raises(ValueError, match="selected_codes out of range"):
        MLModel(W, C, bias=1.0, device="cpu").get_submodel(selected_codes=[8])


@pytest.fixture(scope="module")
def models(jax_model_folder):  # noqa: F811
    folder, X, Y = jax_model_folder
    return X, Y, JaxXLinear.load(folder), XLinearModel.load(folder, device="cpu")


@pytest.mark.parametrize("pp", PPS)
def test_layer_loop_matches_chain(models, pp):
    """The port's twin of tests/test_xlinear.py::test_chain_vs_layer_loop_consistency."""
    X, _, jm, port = models
    fused = port.predict(X, beam_size=6, only_topk=4, post_processor=pp)
    params = port.model.get_pred_params()
    for p in params.model_chain:
        p.post_processor, p.only_topk = pp, 4
    loop = port.model._predict_layer_loop(X, pred_params=params, beam_size=6)
    _assert_close_dense(fused, loop)
    jparams = jm.model.get_pred_params()
    for p in jparams.model_chain:
        p.post_processor, p.only_topk = pp, 4
    want = jm.model._predict_layer_loop(X, pred_params=jparams, beam_size=6)
    np.testing.assert_array_equal(loop.indptr, want.indptr)
    np.testing.assert_array_equal(loop.indices, want.indices)
    # log-* path values add one term per layer, each of scale ~1 and each off
    # by about a float32 ulp when the sums run in another order: atol 1e-6
    np.testing.assert_allclose(loop.data, want.data, rtol=1e-5, atol=1e-6)


def test_csr_codes_predict_matches_jax(models):
    """A starting beam over the top layer's codes runs the layer loop."""
    X, _, jm, port = models
    rng = np.random.default_rng(1)
    n_codes = port.model.nr_codes
    codes = smat.csr_matrix(rng.uniform(0.5, 1.0, size=(X.shape[0], n_codes)) * (rng.random((X.shape[0], n_codes)) < 0.6))
    kw = dict(csr_codes=codes, beam_size=3, only_topk=5)
    assert_same_predictions(jm.predict(X, **kw), port.predict(X, **kw))


def test_hierarchical_selected_outputs_match_jax(models):
    X, _, jm, port = models
    P = port.predict(X, beam_size=16, only_topk=4)
    S = port.predict_on_selected_outputs(X, P)
    assert_same_predictions(jm.predict_on_selected_outputs(X, P), S)
    # re-scoring the predicted pairs gives the predicted values
    # (the JAX package's tests/test_model_surgery.py idiom and tolerance)
    _assert_close_dense(P, S)


def test_add_getitem_astype_match_jax(models):
    X, _, jm, port = models
    hm, jhm = port.model, jm.model
    assert hm.depth >= 2
    cut = hm.depth - 1
    combo = hm[:cut] + hm[cut:]
    assert combo.depth == hm.depth and hm[0].depth == 1
    kw = dict(beam_size=4, post_processor=LOG_PP)
    assert_same_predictions(hm.predict(X, **kw), combo.predict(X, **kw))
    assert_same_predictions((jhm[:cut] + jhm[cut:]).predict(X, **kw), combo.predict(X, **kw))
    assert_same_predictions(hm.predict(X, **kw), hm.astype(np.float64).predict(X, **kw))
    with pytest.raises(ValueError, match="not compatible"):
        hm[cut:] + hm[:cut]


def _surgery_models(folder):
    return JaxXLinear.load(folder), XLinearModel.load(folder, device="cpu")


def test_set_output_constraint_matches_jax(jax_model_folder):  # noqa: F811
    folder, X, _ = jax_model_folder
    jm, port = _surgery_models(folder)
    keep = [0, 1, 2, 3, 8, 9, 17, 30]
    jm.set_output_constraint(keep)
    port.set_output_constraint(keep)
    for a, b in zip(jm.model.model_chain, port.model.model_chain):
        assert (a.C != b.C).nnz == 0
    kw = dict(beam_size=16, only_topk=16, post_processor=LOG_PP)
    P = port.predict(X, **kw)
    assert set(P.indices.tolist()) <= set(keep)
    assert_same_predictions(jm.predict(X, **kw), P)


@pytest.mark.parametrize("reindex", [False, True])
def test_split_and_reconstruct_match_jax(jax_model_folder, reindex):  # noqa: F811
    folder, X, Y = jax_model_folder
    jm, port = _surgery_models(folder)
    got, want = port.split_model_at_depth(1, reindex=reindex), jm.split_model_at_depth(1, reindex=reindex)
    assert got["parent_model"].depth == want["parent_model"].depth == 1
    assert len(got["child_models"]) == len(want["child_models"]) == port.model.model_chain[1].nr_codes
    for (sub, mapping), (jsub, jmapping) in zip(got["child_models"], want["child_models"]):
        assert sub.depth == jsub.depth
        if reindex:
            np.testing.assert_array_equal(mapping, jmapping)
        else:
            assert mapping is None and jmapping is None
        for a, b in zip(sub.model_chain, jsub.model_chain):
            assert a.W.shape == b.W.shape and (a.W != b.W).nnz == 0
            assert a.C.shape == b.C.shape and (a.C != b.C).nnz == 0
    if reindex:
        # subtrees in code order partition the labels; stacking them back gives
        # one chain whose labels are the subtrees' in that order
        subs = [s for s, _ in got["child_models"]]
        order = np.concatenate([m for _, m in got["child_models"]])
        np.testing.assert_array_equal(np.sort(order), np.arange(Y.shape[1]))
        rec = XLinearModel.reconstruct_model(got["parent_model"], subs)
        jrec = JaxXLinear.reconstruct_model(want["parent_model"], [s for s, _ in want["child_models"]])
        for a, b in zip(rec.model.model_chain, jrec.model.model_chain):
            assert (a.W != b.W).nnz == 0 and (a.C != b.C).nnz == 0
        kw = dict(beam_size=4, only_topk=5)
        assert_same_predictions(jrec.predict(X, **kw), rec.predict(X, **kw))
        P_full = port.predict(X, **kw)
        P_rec = rec.predict(X, **kw)
        np.testing.assert_array_equal(order[P_rec.indices], P_full.indices)


def test_submodel_rooted_at_and_statistics_match_jax(jax_model_folder):  # noqa: F811
    folder, X, _ = jax_model_folder
    jm, port = _surgery_models(folder)
    sub, mapping = port.get_submodel_rooted_at(1, 0, reindex=True)
    jsub, jmapping = jm.get_submodel_rooted_at(1, 0, reindex=True)
    np.testing.assert_array_equal(mapping, jmapping)
    kw = dict(beam_size=4, only_topk=len(mapping), post_processor="log-l3-hinge")
    assert_same_predictions(jsub.predict(X[:8], **kw), sub.predict(X[:8], **kw))
    assert port.model.get_layer_statistics() == jm.model.get_layer_statistics()
    with pytest.raises(ValueError, match="given_depth"):
        port.split_model_at_depth(0)


def test_predict_only_surgery_raises(jax_model_folder, tmp_path):  # noqa: F811
    from pecos_tpu_torch.xmc import HierarchicalMLModel

    folder, _, _ = jax_model_folder
    hm = HierarchicalMLModel.load(folder + "/ranker", is_predict_only=True, device="cpu")
    for call in (lambda: hm.set_output_constraint([0]), lambda: hm.get_submodel_rooted_at(1, 0),
                 lambda: hm.split_model_at_depth(1), lambda: hm.save(str(tmp_path / "m"))):
        with pytest.raises(ValueError, match="predict only"):
            call()


def test_evaluate_cli_matches_jax(models, tmp_path, capsys):
    X, Y, _, port = models
    y_path, p_path = str(tmp_path / "Y.npz"), str(tmp_path / "P.npz")
    smat_util.save_matrix(y_path, Y)
    smat_util.save_matrix(p_path, port.predict(X, beam_size=4, only_topk=5))
    evaluate_cli.main(["-y", y_path, "-p", p_path, "-k", "5"])
    got = capsys.readouterr().out
    jax_evaluate.main(["-y", y_path, "-p", p_path, "-k", "5"])
    assert got == capsys.readouterr().out and got.startswith("prec   = ")
