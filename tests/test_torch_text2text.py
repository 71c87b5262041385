"""The port's Text2Text against the JAX package's on tests/test_text2text.py's
toy data (CPU): folders written by either package load in the other and
predict the same items, with scores within rtol 1e-5 and atol 1e-7 (the
tolerance of tests/test_torch_xlinear.py, the same predict on the same
weights).  Trains are held to quality, the JAX package's bar of top-1
accuracy > 0.9: clustering draws from another RNG (ROADMAP F5, RNG)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pecos_tpu.apps.text2text import Text2Text as JText2Text
from pecos_tpu_torch.apps.text2text import Text2Text
from pecos_tpu_torch.utils.featurization.text import Preprocessor

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(indexer_kwargs={"max_leaf_size": 4, "nr_splits": 2}, xlinear_kwargs={"threshold": 0.0})
QUERIES = [f"tell me about keyword{i}" for i in range(12)] + ["keyword3 and keyword7 together", "nothing known here"]
METHODS = ["average", "rank_average", "sigmoid_average", "softmax_average", "round_robin"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("t2t")
    (d / "items.txt").write_text("\n".join(f"item number {i} keyword{i}" for i in range(12)) + "\n")
    (d / "input.txt").write_text("\n".join(f"{i % 12}\tquery text mentioning keyword{i % 12} and stuff" for i in range(96)) + "\n")
    return d


def _train_port(data, **kwargs):
    return Text2Text.train(str(data / "input.txt"), str(data / "items.txt"), device="cpu", **{**SMALL, **kwargs})


def _assert_same_predictions(got_model, want_model, topk=5):
    got = got_model.predict(QUERIES, topk=topk, ret_csr=True)
    want = want_model.predict(QUERIES, topk=topk, ret_csr=True)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, rtol=1e-5, atol=1e-7)
    items = got_model.predict(QUERIES, topk=topk)
    assert [[it for it, _ in row] for row in items] == [[it for it, _ in row] for row in want_model.predict(QUERIES, topk=topk)]


def _top1_accuracy(model):
    top1 = [r[0][0] for r in model.predict(QUERIES[:12], topk=3)]
    return np.mean([t.endswith(f"keyword{i}") for i, t in enumerate(top1)])


def test_jax_folder_loads_in_port(data, tmp_path):
    jmodel = JText2Text.train(str(data / "input.txt"), str(data / "items.txt"), **SMALL)
    jmodel.save(str(tmp_path / "jax"))
    model = Text2Text.load(str(tmp_path / "jax"), device="cpu")
    assert model.output_items == jmodel.output_items and len(model.xlinear_models) == 1
    _assert_same_predictions(model, jmodel)


def test_port_train_quality_and_folder_loads_in_jax(data, tmp_path):
    model = _train_port(data)
    assert _top1_accuracy(model) > 0.9
    model.save(str(tmp_path / "torch"))
    assert sorted(os.listdir(tmp_path / "torch")) == ["0.model", "output_items.json", "param.json", "preprocessor"]
    _assert_same_predictions(model, JText2Text.load(str(tmp_path / "torch")))
    _assert_same_predictions(Text2Text.load(str(tmp_path / "torch"), device="cpu"), model)


def test_ensemble_members_and_methods(data, tmp_path):
    model = _train_port(data, label_embed_type=["pifa", "pii"], ensemble_seeds=[0, 1])
    assert len(model.xlinear_models) == 4
    assert [len(r) for r in model.predict(["about keyword3"], topk=2)] == [2]
    model.save(str(tmp_path / "ens"))
    jmodel = JText2Text.load(str(tmp_path / "ens"))
    for method in METHODS:
        model.ens_method = jmodel.ens_method = method
        _assert_same_predictions(model, jmodel, topk=4)
        assert _top1_accuracy(model) > 0.9, method


@pytest.mark.parametrize("layout", ["dense", "plabel"])
def test_plain_reference_of_chip_smoke(data, monkeypatch, layout):
    """chip_smoke.py's plain predict (sparse products over each level's real
    nonzeros, no padded layout, no K1), which holds the card where the
    port's CPU path is too large to run, against the port's predict with
    dense layers and with plabel layers (K1's plain version): equal items,
    scores within the tolerance above."""
    import importlib.util

    from pecos_tpu_torch.xmc import inference

    if layout == "plabel":
        monkeypatch.setattr(inference, "DENSE_LAYOUT_MAX_ELEMENTS", 0)

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    model = _train_port(data, ensemble_seeds=[0, 1], ens_method="rank_average")
    for m in model.xlinear_models:
        assert {l.kind for l in m.model._get_compiled().layers} == {layout}
        X = model.preprocessor.predict(QUERIES)
        got, want = chip_smoke.plain_xlinear_predict(m, X, 3, 5), m.predict(X, beam_size=3, only_topk=5)
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_allclose(got.data, want.data, rtol=1e-5, atol=1e-7)
    X = model.preprocessor.predict(QUERIES)
    plain = [chip_smoke.plain_xlinear_predict(m, X, 10, 10) for m in model.xlinear_models]
    got, want = chip_smoke.ensemble_topk(model, plain, 4), model.predict(QUERIES, topk=4, ret_csr=True)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, rtol=1e-5, atol=1e-7)
    # phase 13b's score check and its K1 check at the path's shapes, here
    # through K1's plain version
    for m in model.xlinear_models:
        n, err = chip_smoke.check_scores(m.predict(X, beam_size=10, only_topk=10), chip_smoke.plain_xlinear_predict(m, X, 10, 10), "scores")
        assert n == m.predict(X, beam_size=10, only_topk=10).nnz and err <= 1e-6
    assert chip_smoke.check_k1_text2text(model.xlinear_models, model.xlinear_models, X) <= 1e-5
    with pytest.raises(RuntimeError, match="outside"):
        bent = chip_smoke.plain_xlinear_predict(model.xlinear_models[0], X, 10, 10)
        bent.data[3] += 1e-3
        chip_smoke.check_scores(model.xlinear_models[0].predict(X, beam_size=10, only_topk=10), bent, "bent")


def test_jax_reference_script_matches_jax_predict(data):
    """tests/text2text_reference.py's plain predict, from the JAX package's
    own pieces, equals the JAX package's Text2Text.predict where that can
    run: the items, and the scores within the tolerance above."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("text2text_reference", REPO / "tests" / "text2text_reference.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    jmodel = JText2Text.train(str(data / "input.txt"), str(data / "items.txt"), ensemble_seeds=[0, 1], ens_method="rank_average", **SMALL)
    queries = QUERIES[:-1]  # a text with no known n-gram is refused (ROADMAP F9)
    for topk, beam in ((4, 10), (3, 2)):
        got, want = ref.plain_predict(jmodel, queries, topk, beam), jmodel.predict(queries, topk=topk, beam_size=beam, ret_csr=True)
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_allclose(got.data, want.data, rtol=1e-5, atol=1e-7)
    with pytest.raises(RuntimeError, match="known n-gram"):
        ref.plain_predict(jmodel, QUERIES, 4, 10)


def test_cached_workspace(data, tmp_path, monkeypatch):
    ws = str(tmp_path / "ws")
    first = _train_port(data, workspace_folder=ws)
    assert any(f.startswith("X_feat") for f in os.listdir(ws))

    def no_train(*args, **kwargs):
        raise AssertionError("the workspace holds the features: no second vectorizer train")

    monkeypatch.setattr(Preprocessor, "train", no_train)
    again = _train_port(data, workspace_folder=ws)  # reuses the pickled preprocessor and X
    _assert_same_predictions(again, first)


def test_clis(data, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    run = lambda mod, *args: subprocess.run(
        [sys.executable, "-m", f"pecos_tpu_torch.apps.text2text.{mod}", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    folder, pred = tmp_path / "cli_model", tmp_path / "pred.jsonl"
    proc = run("train", "-i", str(data / "input.txt"), "-q", str(data / "items.txt"), "-m", str(folder),
               "--max-leaf-size", "4", "--nr-splits", "2", "-t", "0", "--ensemble-seeds", "0,1",
               "--ens-method", "rank_average", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert json.loads((folder / "param.json").read_text())["nr_ensembles"] == 2
    proc = run("predict", "-i", str(data / "input.txt"), "-m", str(folder), "-o", str(pred), "-k", "3", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    rows = [json.loads(line)["data"] for line in pred.read_text().splitlines()]
    corpus = Preprocessor.load_data_from_file(str(data / "input.txt"))["corpus"]
    want = Text2Text.load(str(folder), device="cpu").predict(corpus, topk=3)
    assert [[(e["item"], e["score"]) for e in r] for r in rows] == [[(it, sc) for it, sc in r] for r in want]
    proc = run("evaluate", "-i", str(data / "input.txt"), "-p", str(pred), "-q", str(data / "items.txt"), "-k", "3")
    assert proc.returncode == 0, proc.stderr
    prec = [float(x) for x in proc.stdout.splitlines()[0].split("=")[1].split()]
    assert len(prec) == 3 and prec[0] > 90.0


def test_cuda_without_a_card_raises(data, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        Text2Text.train(str(data / "input.txt"), str(data / "items.txt"), **SMALL)
    _train_port(data).save(str(tmp_path / "m"))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        Text2Text.load(str(tmp_path / "m"))
