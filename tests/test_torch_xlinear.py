"""XLinearModel across the two packages: one model folder format.

A model trained and saved by the JAX package loads in the port and predicts
the same labels and P@1..5 on the CPU; a folder saved by the port loads in the
JAX package with the same result.  Scores agree to rtol=1e-5 (float32 sums in
another order), atol=1e-7 for values that cancel towards zero.
"""

import numpy as np
import pytest
import scipy.sparse as smat
import torch

from pecos_tpu.utils import smat_util as jax_smat_util
from pecos_tpu.xmc import Indexer, LabelEmbeddingFactory
from pecos_tpu.xmc.xlinear import XLinearModel as JaxXLinear
from pecos_tpu_torch.parallel.mesh import make_mesh
from pecos_tpu_torch.utils import smat_util
from pecos_tpu_torch.xmc.xlinear import XLinearModel
from pecos_tpu_torch.xmc.xlinear import predict as predict_cli


def _synthetic_xmc(n=240, d=16, L=32, seed=0):
    """Separable multi-label data: each label is a Gaussian blob direction."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((L, d)).astype(np.float32) * 3
    labels = np.arange(n) % L
    X = centers[labels] + rng.standard_normal((n, d)).astype(np.float32) * 0.25
    rows = np.concatenate([np.arange(n), np.arange(0, n, 7)])
    cols = np.concatenate([labels, (labels[::7] + 1) % L])
    Y = smat.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)), shape=(n, L))
    return smat.csr_matrix(X), Y


@pytest.fixture(scope="module")
def jax_model_folder(tmp_path_factory):
    X, Y = _synthetic_xmc()
    chain = Indexer.gen(LabelEmbeddingFactory.create(Y, X, method="pifa"), max_leaf_size=4, nr_splits=2, seed=7)
    xlm = JaxXLinear.train(X, Y, C=chain, threshold=0.0)
    folder = str(tmp_path_factory.mktemp("xlm") / "jax_model")
    xlm.save(folder)
    return folder, X, Y


def _assert_same(P_jax, P_port, Y):
    np.testing.assert_array_equal(P_port.indptr, P_jax.indptr)
    np.testing.assert_array_equal(P_port.indices, P_jax.indices)
    np.testing.assert_allclose(P_port.data, P_jax.data, rtol=1e-5, atol=1e-7)
    m_port = smat_util.Metrics.generate(Y, P_port, topk=5)
    m_jax = jax_smat_util.Metrics.generate(Y, P_jax, topk=5)
    np.testing.assert_array_equal(m_port.prec, m_jax.prec)
    np.testing.assert_array_equal(m_port.recall, m_jax.recall)
    return m_port


@pytest.mark.parametrize("pp", ["l3-hinge", "noop"])
def test_jax_folder_loads_in_port(jax_model_folder, pp):
    folder, X, Y = jax_model_folder
    port = XLinearModel.load(folder, device="cpu")
    assert port.device == torch.device("cpu")
    kw = dict(beam_size=4, only_topk=5, post_processor=pp)
    m = _assert_same(JaxXLinear.load(folder).predict(X, **kw), port.predict(X, **kw), Y)
    if pp == "l3-hinge":  # the default combines the path; noop ranks by the last layer alone
        assert m.prec[0] > 0.9


def test_port_folder_loads_in_jax(jax_model_folder, tmp_path):
    folder, X, Y = jax_model_folder
    out = str(tmp_path / "port_model")
    XLinearModel.load(folder, device="cpu").save(out)
    port = XLinearModel.load(out, device="cpu")
    jm = JaxXLinear.load(out)
    assert jm.model.depth == port.model.depth
    kw = dict(beam_size=4, only_topk=5)
    _assert_same(jm.predict(X, **kw), port.predict(X, **kw), Y)


def test_predict_cli_matches_jax(jax_model_folder, tmp_path):
    folder, X, Y = jax_model_folder
    x_path, y_path, pred_path = (str(tmp_path / f) for f in ("X.npz", "Y.npz", "P.npz"))
    smat_util.save_matrix(x_path, X)
    smat_util.save_matrix(y_path, Y)
    predict_cli.main(["-x", x_path, "-m", folder, "-o", pred_path, "-y", y_path, "-b", "4", "-k", "5", "--device", "cpu"])
    _assert_same(JaxXLinear.load(folder).predict(X, beam_size=4, only_topk=5), smat_util.load_matrix(pred_path), Y)


def test_cuda_without_gpu_raises(jax_model_folder):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        XLinearModel.load(jax_model_folder[0])  # device defaults to cuda


def test_unported_paths_raise(jax_model_folder):
    """csr_codes (a starting beam over the top layer's codes) predicts the JAX
    package's labels, and ignores the mesh kwarg as the JAX package does; the
    mesh kwarg, once a path left out, predicts the JAX package's labels."""
    folder, X, Y = jax_model_folder
    port = XLinearModel.load(folder, device="cpu")
    n_codes = port.model.nr_codes
    codes = smat.csr_matrix(np.tile(np.arange(1, n_codes + 1, dtype=np.float32) / n_codes, (X.shape[0], 1)))
    kw = dict(csr_codes=codes, beam_size=4, only_topk=5)
    want = JaxXLinear.load(folder).predict(X, **kw)
    _assert_same(want, port.predict(X, **kw), Y)
    _assert_same(want, port.predict(X, mesh=object(), **kw), Y)
    mesh = make_mesh(4, devices=["cpu"] * 4)
    _assert_same(JaxXLinear.load(folder).predict(X, beam_size=4, only_topk=5), port.predict(X, mesh=mesh, beam_size=4, only_topk=5), Y)
