"""The HNSW model of the port (pecos_tpu_torch.ann.hnsw.HNSW) against the JAX
package, on the CPU: builds, recall, folders in both directions, the chunked
predict and the two CLIs.

A float32 build of the port is the JAX package's build edge for edge (same
numpy level draws, same batches, ties broken alike, random float data has
none), so those builds are compared for equality.  The default dense build
searches a bfloat16 copy, whose sums round elsewhere than XLA's, so it is
held at the reference's recall bar instead: recall@10 >= 0.99 against brute
force at efS 50/75/100 (test_hnsw.py's bar).  Searches over one graph are
compared on (row, rank) ids: equal on >= 99% across packages' folders,
equal outright over the same arrays in memory.
"""

import numpy as np
import pytest
import scipy.sparse as smat

from pecos_tpu.ann import HNSW as JaxHNSW
from pecos_tpu_torch.ann import HNSW
from pecos_tpu_torch.ann.hnsw import predict as predict_cli
from pecos_tpu_torch.ann.hnsw import train as train_cli
from pecos_tpu_torch.utils import smat_util


def _data(n=400, nq=50, d=16, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((nq, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    Q /= np.linalg.norm(Q, axis=1, keepdims=True)
    return X, Q


def _exact_topk(X, Q, k, metric):
    d = 1.0 - Q @ X.T if metric == "ip" else ((Q[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    return np.argsort(d, axis=1, kind="stable")[:, :k]


def _recall(pred, true):
    return sum(len(set(p.tolist()) & set(t.tolist())) for p, t in zip(pred, true)) / true.size


def _port_of(jm, device="cpu"):
    """The port's HNSW over the arrays of a JAX-built one."""
    return HNSW(jm.feats, jm.neighbors0, jm.upper_neighbors, jm.node_levels, jm.entry_point, jm.metric, device=device)


# name -> (points, train kwargs): float32 builds, eager dense and sparse, and the
# scan mode (its level-0 sweep and partial refine; the full refine is the eager one's)
BUILDS = {
    "dense-eager-l2": (300, dict(M=8, efC=40, metric_type="l2", max_level_upper_bound=3)),
    "sparse-eager-ip": (300, dict(M=8, efC=40, metric_type="ip", max_level_upper_bound=3, data_type="csr", build_batch_size=64)),
    "dense-scan-partial-l2": (300, dict(M=8, efC=40, metric_type="l2", max_level_upper_bound=3, build_batch_size=64,
                                        build_scan="true", refine_fraction=0.5)),
}


def _build_input(name, n):
    X, Q = _data(n=n)
    return (smat.csr_matrix(X), smat.csr_matrix(Q)) if name.startswith("sparse") else (X, Q)


@pytest.fixture(scope="module")
def jax_builds():
    """name -> (X, Q, JAX model) for every entry of BUILDS."""
    out = {}
    for name, (n, kw) in BUILDS.items():
        X, Q = _build_input(name, n)
        out[name] = (X, Q, JaxHNSW.train(X, build_dtype="float32", **kw))
    return out


@pytest.mark.parametrize("name", list(BUILDS))
def test_float32_build_equals_jax(jax_builds, name):
    X, _, jm = jax_builds[name]
    tm = HNSW.train(X, build_dtype="float32", device="cpu", **BUILDS[name][1])
    np.testing.assert_array_equal(tm.node_levels, jm.node_levels)
    assert tm.entry_point == jm.entry_point
    assert tm.neighbors0.dtype == np.int32 and tm.upper_neighbors.shape == jm.upper_neighbors.shape
    np.testing.assert_array_equal(tm.neighbors0, jm.neighbors0)
    np.testing.assert_array_equal(tm.upper_neighbors, jm.upper_neighbors)


@pytest.mark.parametrize("name", ["dense-eager-l2", "sparse-eager-ip"])
def test_predict_on_jax_graph_equals_jax(jax_builds, name):
    """Over the same arrays the port returns JAX's ids, also when the queries
    come in zero-padded chunks of batch_size (and, sparse, a row width rounded
    up to 32), and the same CSR."""
    _, Q, jm = jax_builds[name]
    tm = _port_of(jm)
    for kw in (dict(efS=30, topk=10), dict(efS=30, topk=10, batch_size=16)):
        want_i, want_d = jm.predict(Q, **kw)
        got_i, got_d = tm.predict(Q, **kw)
        assert got_i.dtype == np.int32 and got_d.dtype == np.float32
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-5)
    want = jm.predict(Q, efS=30, topk=5, ret_csr=True)
    got = tm.predict(Q, efS=30, topk=5, ret_csr=True)
    assert got.shape == want.shape and (np.diff(got.indptr) == 5).all()
    np.testing.assert_array_equal(got.indices, want.indices)


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_recall_vs_bruteforce(sparse, metric):
    """The port's own default build (bfloat16 search copy when dense)."""
    X, Q = _data()
    kw = dict(data_type="csr", build_batch_size=128) if sparse else {}
    model = HNSW.train(smat.csr_matrix(X) if sparse else X, M=16, efC=60, metric_type=metric,
                       max_level_upper_bound=3, device="cpu", **kw)
    true_ids = _exact_topk(X, Q, 10, metric)
    for efS in (50, 75, 100):
        ids, dists = model.predict(smat.csr_matrix(Q) if sparse else Q, efS=efS, topk=10)
        rec = _recall(ids, true_ids)
        assert rec >= 0.99, f"sparse={sparse} metric={metric} efS={efS} recall={rec}"
        assert (np.diff(dists, axis=1) >= -1e-5).all()


@pytest.mark.parametrize("refine_fraction", [1.0, 0.5])
def test_scan_build_recall(refine_fraction):
    """The scan mode forced at small n: upper levels first, fixed level-0
    batches with same-batch candidates merged, then the full or the partial refine."""
    X, Q = _data(n=600, seed=13)
    model = HNSW.train(X, M=16, efC=60, metric_type="l2", build_batch_size=128, build_scan="true",
                       refine_fraction=refine_fraction, device="cpu")
    true_ids = _exact_topk(X, Q, 10, "l2")
    for efS in (50, 75, 100):
        rec = _recall(model.predict(Q, efS=efS, topk=10)[0], true_ids)
        assert rec >= 0.99, f"refine_fraction={refine_fraction} efS={efS} recall={rec}"


def test_degree_caps():
    X, _ = _data(n=200)
    model = HNSW.train(X, M=8, efC=40, device="cpu")
    n0 = model.neighbors0
    assert n0.shape == (200, 16) and (n0 >= -1).all() and (n0 < 200).all()
    assert not (n0 == np.arange(200)[:, None]).any()  # no self-loops


@pytest.mark.parametrize("name", ["dense-eager-l2", "sparse-eager-ip"])
def test_folders_load_both_ways(jax_builds, name, tmp_path):
    """A JAX-saved folder searches in the port, a port-saved one in JAX."""
    X, Q, jm = jax_builds[name]
    jm.save(str(tmp_path / "jax"))
    port = HNSW.load(str(tmp_path / "jax"), device="cpu")
    assert smat.issparse(port.feats) == name.startswith("sparse")
    assert (port.predict(Q, efS=30, topk=10)[0] == jm.predict(Q, efS=30, topk=10)[0]).mean() >= 0.99
    tm = HNSW.train(X, device="cpu", **BUILDS[name][1], pred_params={"efS": 30, "topk": 7})
    tm.save(str(tmp_path / "port"))
    back = JaxHNSW.load(str(tmp_path / "port"))
    assert back.get_pred_params().topk == 7
    ids, dists = tm.predict(Q)
    assert ids.shape == (Q.shape[0], 7)
    assert (back.predict(Q)[0] == ids).mean() >= 0.99
    again = HNSW.load(str(tmp_path / "port"), device="cpu")
    i2, d2 = again.predict(Q)
    np.testing.assert_array_equal(i2, ids)
    np.testing.assert_allclose(d2, dists, rtol=1e-6)


def test_cli_end_to_end(tmp_path, capsys):
    """train and predict CLIs with --device cpu: the saved CSR and Recall10@10."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((500, 16)).astype(np.float32)
    Xt = X[:50] + 0.01 * rng.standard_normal((50, 16)).astype(np.float32)
    topk = np.argsort(((Xt[:, None, :] - X[None, :, :]) ** 2).sum(-1), axis=1)[:, :10]
    Y = smat.csr_matrix((np.ones(500, np.float32), (np.repeat(np.arange(50), 10), topk.ravel())), shape=(50, 500))
    paths = {k: str(tmp_path / f) for k, f in (("x", "X.npy"), ("xt", "Xt.npy"), ("y", "Y.npz"), ("o", "pred.npz"))}
    np.save(paths["x"], X)
    np.save(paths["xt"], Xt)
    smat_util.save_matrix(paths["y"], Y)
    model_dir = str(tmp_path / "model")
    train_cli.main(["-x", paths["x"], "-m", model_dir, "--metric-type", "l2", "-M", "8", "-efC", "50", "--device", "cpu"])
    assert HNSW.load(model_dir, device="cpu").neighbors0.shape == (500, 16)
    capsys.readouterr()
    predict_cli.main(["-x", paths["xt"], "-m", model_dir, "-efS", "50", "-k", "10", "-y", paths["y"], "-o", paths["o"],
                      "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Recall10@10" in out
    assert float(out.split("Recall10@10")[1].split("%")[0]) >= 99.0, out
    assert smat_util.load_matrix(paths["o"]).shape == (50, 500)
