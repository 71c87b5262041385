"""Distributed XR-Linear in the port (pecos_tpu_torch.parallel.comm,
pecos_tpu_torch.distributed) against the JAX package and the port's own
direct train.

- Chain surgery and the load balancer are integer-equal to the JAX package's
  on the same inputs.
- Clustering draws from torch generators, not jax.random, so a distributed
  clustering is held at the JAX tests' level (valid chains of the same shapes).
- Distributed training is held to the port's direct train over the same
  chain at a tight solve (ROADMAP F5): the subtree models solve the same
  problems on the same rows, so W agrees to rounding (atol 1e-4) and the
  predictions' labels are equal.  It is also held to the JAX package's
  DistributedXLinearModel.train on the same chain, the same comm layout and
  the same tight solve: C equal, W within the solvers' atol 1e-3, predicted
  labels equal.
- MultihostComm runs in 2 gloo processes under a 60 s timeout of its own.
"""

import os
import pickle
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as smat
import torch

from pecos_tpu.distributed.xmc import DistClusterChain as JaxDistClusterChain
from pecos_tpu.distributed.xmc import DistClustering as JaxDistClustering
from pecos_tpu.distributed.xmc.xlinear import DistributedXLinearModel as JaxDistXLinear
from pecos_tpu.distributed.xmc.xlinear import XLinearLoadBalancer as JaxBalancer
from pecos_tpu.parallel.comm import DummyComm as JaxDummyComm
from pecos_tpu.parallel.comm import FakeClusterComm as JaxFakeClusterComm
from pecos_tpu.xmc import Indexer as JaxIndexer
from pecos_tpu.xmc import LabelEmbeddingFactory as JaxLEF
from pecos_tpu.xmc.xlinear import XLinearModel as JaxXLinear
from pecos_tpu_torch.distributed.diagnostic_tools import run_comm_self_test, run_device_collective_probe
from pecos_tpu_torch.distributed.xmc import DistClusterChain, DistClustering
from pecos_tpu_torch.distributed.xmc.base import csc_col_nonzero
from pecos_tpu_torch.distributed.xmc.xlinear import DistributedXLinearModel, XLinearLoadBalancer
from pecos_tpu_torch.distributed.xmc.xlinear import train as train_cli
from pecos_tpu_torch.parallel.comm import DummyComm, FakeClusterComm, MultihostComm
from pecos_tpu_torch.parallel.mesh import make_mesh
from pecos_tpu_torch.utils import smat_util
from pecos_tpu_torch.xmc.xlinear import XLinearModel
from test_distributed import _synthetic

REPO = Path(__file__).resolve().parents[1]
TIGHT = dict(newton_eps=1e-6, max_newton_iter=60, cg_max_iter=60)
HLM_TIGHT = {"model_chain": {"threshold": 0.0, **TIGHT}}
JOIN_S = 60  # every thread or process join of this file; a hang fails the test


def _jax_chain(X, Y, leaf=4, splits=2):
    return JaxIndexer.gen(JaxLEF.create(Y, X, "pifa"), max_leaf_size=leaf, nr_splits=splits)


def _csr_equal(a, b):
    return a.shape == b.shape and (smat.csr_matrix(a) != smat.csr_matrix(b)).nnz == 0


def _chains_equal(a, b):
    return len(a) == len(b) and all(_csr_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("split_depth", [1, 2, 3])
def test_dist_chain_resplit_and_subtree_roundtrip(split_depth):
    """On one chain (the JAX indexer's), every DistClusterChain query and the
    meta / subtree round trip are integer-equal to the JAX package's."""
    X, Y = _synthetic()
    chain = _jax_chain(X, Y)
    port, jax = DistClusterChain(chain.chain, split_depth), JaxDistClusterChain(chain, split_depth)
    n_sub = port.get_num_sub_tree()
    assert n_sub == jax.get_num_sub_tree() == chain[split_depth].shape[1]
    assert (port.get_nr_splits(), port.get_avg_leaf_size()) == (jax.get_nr_splits(), jax.get_avg_leaf_size())
    assignments = port.get_sub_tree_assignment()
    assert sorted(np.concatenate(assignments).tolist()) == list(range(Y.shape[1]))
    for a, b in zip(assignments, jax.get_sub_tree_assignment()):
        np.testing.assert_array_equal(a, b)
    subs = [port.get_sub_tree_chain(t) for t in range(n_sub)]
    for t, sub in enumerate(subs):
        assert sub[-1].shape[0] == len(assignments[t])
        assert _chains_equal(sub, jax.get_sub_tree_chain(t))
    assert _csr_equal(port.get_meta_Y(Y), jax.get_meta_Y(Y)) and port.get_meta_Y(Y).shape == (X.shape[0], n_sub)
    assert _chains_equal(port.get_meta_tree_chain(), jax.get_meta_tree_chain())
    for m in (1, 2, 3, 5):
        assert port.new_instance_re_split(m).get_split_depth() == jax.new_instance_re_split(m).get_split_depth()
    # meta chain (ending in label -> subtree) + subtree chains give back the chain
    meta = list(port.get_meta_tree_chain()) + [port.get_meta_tree_leaf_cluster()]
    depth = max(len(s) for s in subs)
    if all(len(s) == depth for s in subs):
        again = DistClusterChain.assemble_from_meta_sub_chain(meta, subs)
        jagain = JaxDistClusterChain.assemble_from_meta_sub_chain(meta, [jax.get_sub_tree_chain(t) for t in range(n_sub)])
        assert _chains_equal(again.get_cluster_chain(), jagain.get_cluster_chain())
        assert _chains_equal(again.get_cluster_chain(), chain)
        assert again.get_split_depth() == split_depth
    with pytest.raises(ValueError, match="split_depth"):
        DistClusterChain(chain.chain, len(chain))


@pytest.mark.parametrize("factor", [0.3, 0.5, 1.0])
@pytest.mark.parametrize("n_machines", [1, 2, 3, 5])
def test_load_balancer_partition_matches_jax(factor, n_machines):
    rng = np.random.default_rng(n_machines)
    for w in (np.array([5.0, 1, 1, 1, 5, 1, 1, 1]), rng.uniform(0.1, 10.0, size=17), np.ones(3)):
        jobs = XLinearLoadBalancer(main_workload_factor=factor).partition(w, n_machines)
        assert jobs == JaxBalancer(main_workload_factor=factor).partition(w, n_machines)
        assert [x for j in jobs for x in j] == list(range(len(w)))  # contiguous, in order, each once
    X, Y = _synthetic()
    dist = DistClusterChain(_jax_chain(X, Y).chain, 2)
    np.testing.assert_allclose(
        XLinearLoadBalancer.subtree_workloads(Y, dist),
        JaxBalancer.subtree_workloads(Y, JaxDistClusterChain(dist.get_cluster_chain().chain, 2)),
    )


def test_dist_clustering_dummycomm():
    """Held at the JAX tests' level (the RNGs differ): a valid chain over
    every label, with the JAX package's level shapes."""
    X, Y = _synthetic(seed=1)
    kw = dict(cluster_params={"indexer_params": {"nr_splits": 2, "max_leaf_size": 4}}, min_n_sub_tree=2)
    dist = DistClustering.dist_get_cluster_chain(X, Y, DummyComm(), device="cpu", **kw)
    chain = dist.get_cluster_chain()
    assert chain.nr_labels == Y.shape[1]
    for C in chain:
        assert (np.diff(C.tocsr().indptr) == 1).all()
    jchain = JaxDistClustering.dist_get_cluster_chain(X, Y, JaxDummyComm(), **kw).get_cluster_chain()
    assert [C.shape for C in chain] == [C.shape for C in jchain]
    assert dist.get_split_depth() >= 1 and dist.get_num_sub_tree() >= 2


def _assert_matches_direct(model_dist, chain, X, Y):
    """The distributed model against the direct train over the same chain at a tight solve."""
    model_direct = XLinearModel.train(X, Y, C=chain, threshold=0.0, shallow=True, device="cpu", **TIGHT)
    chain_d, chain_t = model_dist.model.model_chain, model_direct.model.model_chain
    assert len(chain_d) == len(chain_t)
    for a, b in zip(chain_d, chain_t):
        assert a.W.shape == b.W.shape and _csr_equal(a.C, b.C)
        np.testing.assert_allclose(a.W.toarray(), b.W.toarray(), atol=1e-4)
    kw = dict(beam_size=4, only_topk=3)
    P1, P2 = model_dist.predict(X, **kw), model_direct.predict(X, **kw)
    np.testing.assert_array_equal(P1.indices, P2.indices)
    np.testing.assert_allclose(P1.data, P2.data, rtol=1e-3, atol=1e-4)


def _assert_matches_jax(model_dist, dist, X, Y, n_ranks):
    """The port's distributed model against the JAX package's
    DistributedXLinearModel.train on the same chain and split depth, over
    ``n_ranks`` ranks (JAX DummyComm for 1, JAX FakeClusterComm threads
    otherwise) at the same tight solve."""
    jdist = JaxDistClusterChain(dist.get_cluster_chain().chain, dist.get_split_depth())
    train = lambda comm: JaxDistXLinear.train(X, Y, comm, dist_chain=jdist, train_params={"hlm_args": HLM_TIGHT})
    model_jax = train(JaxDummyComm()) if n_ranks == 1 else _run_ranks(n_ranks, train, JaxFakeClusterComm)[0]
    chain_p, chain_j = model_dist.model.model_chain, model_jax.model.model_chain
    assert len(chain_p) == len(chain_j)
    for a, b in zip(chain_p, chain_j):
        assert a.W.shape == b.W.shape and _csr_equal(a.C, b.C)
        np.testing.assert_allclose(a.W.toarray(), smat.csr_matrix(b.W).toarray(), atol=1e-3)
    kw = dict(beam_size=4, only_topk=3)
    np.testing.assert_array_equal(model_dist.predict(X, **kw).indices, model_jax.predict(X, **kw).indices)


def test_distributed_train_matches_direct():
    X, Y = _synthetic(seed=2)
    comm = DummyComm()
    dist = DistClustering.dist_get_cluster_chain(
        X, Y, comm, cluster_params={"indexer_params": {"nr_splits": 2, "max_leaf_size": 4}}, min_n_sub_tree=2, device="cpu"
    )
    model = DistributedXLinearModel.train(X, Y, comm, dist_chain=dist, train_params={"hlm_args": HLM_TIGHT}, device="cpu")
    _assert_matches_direct(model, dist.get_cluster_chain(), X, Y)
    _assert_matches_jax(model, dist, X, Y, n_ranks=1)


def _run_ranks(size, fn, cluster_cls=FakeClusterComm):
    """fn(rank_comm) on ``size`` threads of a ``cluster_cls`` (the port's
    FakeClusterComm or the JAX package's); returns the results by rank."""
    cluster = cluster_cls(size)
    results, errors = [None] * size, []

    def run(r):
        try:
            results[r] = fn(cluster.rank_comm(r))
        except Exception as e:  # a rank's failure fails the test, with its traceback
            errors.append(e)
            raise

    threads = [threading.Thread(target=run, args=(r,)) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a rank did not finish"
    assert not errors, errors[0]
    return results


def test_multirank_distributed_train_matches_direct():
    """3 FakeClusterComm ranks: meta clustering on rank 0, subtree builds
    spread over the ranks, sub-models gathered and joined on rank 0."""
    X, Y = _synthetic(n=200, L=48, seed=3)

    def rank(comm):
        dist = DistClustering.dist_get_cluster_chain(
            X, Y, comm, cluster_params={"indexer_params": {"nr_splits": 2, "max_leaf_size": 4}}, min_n_sub_tree=4, device="cpu"
        )
        return DistributedXLinearModel.train(X, Y, comm, dist_chain=dist, train_params={"hlm_args": HLM_TIGHT}, device="cpu"), dist

    results = _run_ranks(3, rank)
    assert results[0][0] is not None and all(r[0] is None for r in results[1:])
    assert all(_chains_equal(r[1].get_cluster_chain(), results[0][1].get_cluster_chain()) for r in results[1:])
    _assert_matches_direct(results[0][0], results[0][1].get_cluster_chain(), X, Y)
    _assert_matches_jax(results[0][0], results[0][1], X, Y, n_ranks=3)


def test_fake_cluster_comm_primitives():
    def rank(c):
        r = c.get_rank()
        assert c.bcast("hello" if r == 1 else None, root=1) == "hello"
        assert c.scatter([10, 20, 30] if r == 0 else None, root=0) == 10 * (r + 1)
        g = c.gather(r * r, root=2)
        assert (g == [0, 1, 4]) if r == 2 else g is None
        if r == 0:
            c.send({"payload": np.arange(5)}, dest=2, tag=7)
        if r == 2:
            np.testing.assert_array_equal(c.recv(source=0, tag=7)["payload"], np.arange(5))
        return run_comm_self_test(c, verbose=False)

    assert _run_ranks(3, rank) == [[], [], []]


def test_dummy_comm_and_device_probe():
    comm = DummyComm()
    assert run_comm_self_test(comm) == []
    comm.send("x", dest=0, tag=3)
    assert comm.recv(source=0, tag=3) == "x"
    with pytest.raises(RuntimeError, match="no message"):
        comm.recv(source=0, tag=3)
    assert run_device_collective_probe(make_mesh(devices=["cpu"] * 8))
    with pytest.raises(RuntimeError, match="process group"):
        MultihostComm()


_GLOO_WORKER = r"""
import pickle, sys
import numpy as np
import torch.distributed as dist
from pecos_tpu_torch.distributed.diagnostic_tools import run_comm_self_test
from pecos_tpu_torch.parallel.comm import MultihostComm
from pecos_tpu_torch.utils.cluster_util import ClusterChain
import scipy.sparse as smat

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
comm = MultihostComm()
result = {"size": comm.get_size(), "failures": run_comm_self_test(comm, verbose=False)}
chain = comm.bcast(ClusterChain([smat.csc_matrix(np.ones((4, 1), np.float32))]) if rank == 0 else None, root=0)
result["chain"] = [C.shape for C in chain]
if rank == 0:
    comm.send({"big": np.arange(600_000, dtype=np.int64)}, dest=1, tag=7)
    comm.send("second", dest=1, tag=7)
    comm.send("other tag", dest=1, tag=8)
    result["echo"] = comm.recv(source=1, tag=9)
else:
    result["tag8"] = comm.recv(source=0, tag=8)
    big = comm.recv(source=0, tag=7)
    result["second"] = comm.recv(source=0, tag=7)
    comm.send(int(big["big"].sum()), dest=0, tag=9)
dist.destroy_process_group()
with open(out, "wb") as f:
    pickle.dump(result, f)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_multihost_comm_two_gloo_processes(tmp_path):
    """MultihostComm between 2 processes of a gloo group: the self test, a
    broadcast ClusterChain, and tagged point-to-point messages (one larger
    than a megabyte, two on one tag in order, one on another tag read first)."""
    script = tmp_path / "worker.py"
    script.write_text(_GLOO_WORKER)
    port, outs = _free_port(), [tmp_path / f"out{r}.pkl" for r in range(2)]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [
        subprocess.Popen([sys.executable, str(script), str(r), str(port), str(outs[r])], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_S)[0].decode(errors="replace"))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    r0, r1 = (pickle.loads(o.read_bytes()) for o in outs)
    assert r0["failures"] == r1["failures"] == [] and r0["size"] == r1["size"] == 2
    assert r0["chain"] == r1["chain"] == [(4, 1)]
    assert r0["echo"] == sum(range(600_000))
    assert (r1["second"], r1["tag8"]) == ("second", "other tag")


def test_train_cli_and_folder_loads_in_jax(tmp_path):
    """The distributed train CLI with --device cpu (DummyComm); its folder
    loads in both packages and predicts the same labels."""
    X, Y = _synthetic(seed=4)
    smat_util.save_matrix(str(tmp_path / "X.npz"), X)
    smat_util.save_matrix(str(tmp_path / "Y.npz"), Y)
    folder = tmp_path / "model"
    train_cli.main(["-x", str(tmp_path / "X.npz"), "-y", str(tmp_path / "Y.npz"), "-m", str(folder),
                    "--nr-splits", "2", "--max-leaf-size", "4", "--min-n-sub-tree", "2", "--device", "cpu"])
    port = XLinearModel.load(str(folder), device="cpu")
    assert port.nr_labels == Y.shape[1]
    kw = dict(beam_size=4, only_topk=3)
    P, Pj = port.predict(X, **kw), JaxXLinear.load(str(folder)).predict(X, **kw)
    np.testing.assert_array_equal(P.indices, Pj.indices)
    np.testing.assert_allclose(P.data, Pj.data, rtol=1e-5, atol=1e-6)
    # the default solve: quality-level parity with a direct train over the same chain (ROADMAP F5)
    direct = XLinearModel.train(X, Y, C=[m.C for m in port.model.model_chain], shallow=True, device="cpu")
    p1 = lambda P_: smat_util.Metrics.generate(Y, P_, topk=1).prec[0]
    assert abs(p1(P) - p1(direct.predict(X, **kw))) <= 0.02
    # the reconstructed bottom layer keeps the original label order: label l's column is its own
    labels_of = csc_col_nonzero(port.model.model_chain[-1].C)
    assert sorted(np.concatenate(labels_of).tolist()) == list(range(Y.shape[1]))
    assert torch.device("cpu") == port.device
