"""PairwiseANN of the port (pecos_tpu_torch.ann.pairwise) against the JAX
package on the same numpy inputs, on the CPU.

Outputs (row ids, found mask, distances, label values) are compared as the
reference's four arrays: ids and mask equal, distances and values allclose at
rtol=1e-5, atol=1e-5 (float32 dots summed in another order; random data has
no distance ties, so the order of the rows is the same).
"""

import numpy as np
import pytest
import scipy.sparse as smat

from pecos_tpu.ann.pairwise import PairwiseANN as JaxPairwiseANN
from pecos_tpu_torch.ann.pairwise import PairwiseANN


def _data(n=60, d=8, L=10, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    Y = smat.random(n, L, density=0.25, random_state=rng, format="csr", dtype=np.float32)
    Y.data[:] = rng.uniform(0.1, 1.0, Y.nnz)
    return X, Y


def _assert_same(got, want):
    I, M, D, V = got
    assert [a.dtype for a in got] == [np.uint32, np.uint32, np.float32, np.float32]
    np.testing.assert_array_equal(M, want[1])
    np.testing.assert_array_equal(I, want[0])
    np.testing.assert_allclose(D, want[2], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(V, want[3], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_predict_equals_jax(metric):
    X, Y = _data(seed=1)
    Yz = Y.tolil()
    Yz[:, 5] = 0  # an empty label column: nothing found
    Yz = smat.csr_matrix(Yz)
    jm = JaxPairwiseANN.train(X, Yz, metric_type=metric)
    tm = PairwiseANN.train(X, Yz, metric_type=metric, device="cpu")
    keys = np.array([0, 3, 5, 7, 7, 9], dtype=np.uint32)
    Q = X[10:16]
    for kw in (dict(), dict(only_topk=3), dict(only_topk=40)):  # 40 > the widest label: zero-padded columns
        _assert_same(tm.predict(Q, keys, **kw), jm.predict(Q, keys, **kw))
    _assert_same(tm.predict(Q[:1], keys, is_same_input=True), jm.predict(Q[:1], keys, is_same_input=True))
    searchers = tm.searchers_create(pred_params={"only_topk": 4})
    _assert_same(tm.predict(smat.csr_matrix(Q), keys, searchers), jm.predict(Q, keys, only_topk=4))
    assert tm.predict(Q, keys)[1][2].sum() == 0


def test_input_checks():
    X, Y = _data()
    tm = PairwiseANN.train(X, Y, device="cpu")
    with pytest.raises(TypeError):
        tm.predict(X[:2], [0, 1])
    with pytest.raises(ValueError, match="feat dim"):
        tm.predict(X[:2, :5], np.array([0, 1], np.uint32))
    with pytest.raises(ValueError, match="rows"):
        tm.predict(X[:3], np.array([0, 1], np.uint32))
    assert (tm.num_input_keys, tm.num_label_keys, tm.feat_dim) == (60, 10, 8)


def test_folders_load_both_ways(tmp_path):
    X, Y = _data(seed=3)
    keys = np.array([4, 6, 1], dtype=np.uint32)
    jm = JaxPairwiseANN.train(X, Y, metric_type="l2", pred_params={"only_topk": 6})
    jm.save(str(tmp_path / "jax"))
    tm = PairwiseANN.load(str(tmp_path / "jax"), device="cpu")
    assert tm.metric == "l2" and tm.get_pred_params().only_topk == 6
    _assert_same(tm.predict(X[:3], keys), jm.predict(X[:3], keys))
    tm.save(str(tmp_path / "port"))
    back = JaxPairwiseANN.load(str(tmp_path / "port"))
    _assert_same(tm.predict(X[:3], keys), back.predict(X[:3], keys))
