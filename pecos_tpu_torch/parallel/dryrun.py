"""Dry run of the mesh: every sharded step once on a toy model.

The counterpart of ``__graft_entry__._dryrun_impl`` (without its ZeRO part,
which belongs to XR-Transformer): a sharded Newton-CG solve, the data-parallel
predict, the label-sharded dense predict (its labels must equal the
data-parallel ones) and the label-sharded sparse predict through K1 (its
labels must equal the single-device predict's).

    python -m pecos_tpu_torch.parallel.dryrun 8 --device cpu    # [cpu] * 8: dp 4, lp 2
    python -m pecos_tpu_torch.parallel.dryrun 4 --device cuda   # the first 4 cards, or one card 4 times
"""

from __future__ import annotations

import argparse

import numpy as np
import scipy.sparse as smat
import torch

from pecos_tpu_torch.utils.torch_util import DeviceLike
from pecos_tpu_torch.xmc import HierarchicalMLModel, MLModel
from pecos_tpu_torch.xmc.inference import CompiledHierModel
from .mesh import Mesh, cuda_devices, make_mesh, mesh_layers, predict_sharded, shard_chain_predict, shard_chain_predict_labels, shard_solve_block


def toy_model(L0: int = 8, L1: int = 64, L2: int = 512, D: int = 128, seed: int = 0, device: DeviceLike = "cpu"):
    """A random 3-layer tree model (L0 / L1 / L2 labels, 16 weights a label,
    bias 1) on ``device`` and 64 dense queries: (HierarchicalMLModel, X)."""
    rng = np.random.default_rng(seed)

    def rand_csc(rows, cols, nnz=16):
        r = np.concatenate([rng.choice(rows, size=min(nnz, rows), replace=False) for _ in range(cols)])
        c = np.repeat(np.arange(cols), min(nnz, rows))
        return smat.csc_matrix((rng.standard_normal(len(r)).astype(np.float32), (r, c)), shape=(rows, cols))

    def tree_csc(children, parents):
        rows = np.arange(children)
        return smat.csc_matrix((np.ones(children, np.float32), (rows, rows * parents // children)), shape=(children, parents))

    sizes = (L0, L1, L2)
    chain = [MLModel(W=rand_csc(D + 1, n), C=tree_csc(n, p), bias=1.0, device=device) for n, p in zip(sizes, (1, L0, L1))]
    return HierarchicalMLModel(chain), rng.standard_normal((64, D)).astype(np.float32)


def dryrun(mesh: Mesh) -> dict:
    """Run every sharded step on ``mesh`` once; raises if an equality fails.
    Returns the shapes it saw."""
    dp, lp = mesh.shape["dp"], mesh.shape["lp"]
    home = mesh.devices[0][0]
    rng = np.random.default_rng(0)
    N, D, Lb = 8 * dp, 16, 8 * lp
    X = rng.standard_normal((N, D)).astype(np.float32)
    y = np.where(rng.uniform(size=(N, Lb)) < 0.1, 1.0, -1.0).astype(np.float32)
    W = shard_solve_block(mesh, X, y, np.ones((N, Lb), np.float32), max_newton=2, cg_max=3)
    if tuple(W.shape) != (D, Lb) or not bool(torch.isfinite(W).all()):
        raise RuntimeError(f"shard_solve_block: W {tuple(W.shape)}, not a finite {(D, Lb)}")

    model, Xq = toy_model(D=D, device=home)
    compiled = model._get_compiled()
    labels, _ = shard_chain_predict(mesh, compiled, Xq[: 8 * mesh.size], beam_size=4, only_topk=5)
    nq = min((16 // dp) * dp, 8 * mesh.size)  # rows both predicts ran
    labels_lp, _ = shard_chain_predict_labels(mesh, compiled, Xq[:nq], beam_size=4, only_topk=5)
    if not torch.equal(labels_lp.cpu(), labels[:nq].cpu()):
        raise RuntimeError("label-sharded predict != replicated predict")

    Ws, Cs = [m.W for m in model.model_chain], [m.C for m in model.model_chain]
    sparse = CompiledHierModel.from_host_chain(Ws, Cs, bias=1.0, layouts=["dense", "dense", "plabel"], device=home)
    Xs = smat.csr_matrix(np.where(np.abs(Xq[:nq]) > 1.0, Xq[:nq], 0.0))
    want = sparse.predict(Xs, beam_size=4, only_topk=5)
    got = predict_sharded(mesh, sparse, Xs, beam_size=4, only_topk=5)
    if not (np.array_equal(want.indices, got.indices) and np.allclose(want.data, got.data, rtol=1e-5, atol=1e-6)):
        raise RuntimeError("sparse label-sharded predict != single-device predict")

    bottom = mesh_layers(compiled, mesh, "labels")[0][0][-1].W
    packed = mesh_layers(sparse, mesh, "labels")[0][0][-1].packed
    out = {
        "mesh": dict(mesh.shape), "W": tuple(W.shape), "pred": tuple(labels.shape),
        "bottom_W": (tuple(compiled.layers[-1].W.shape), tuple(bottom.shape)),
        "packed": (tuple(sparse.layers[-1].packed.shape), tuple(packed.shape)),
    }
    print(
        f"dryrun {dict(mesh.shape)} on {sorted({str(d) for r in mesh.devices for d in r})}: W {out['W']}, pred {out['pred']}; "
        f"lp-sharded bottom layer W {out['bottom_W'][0]} -> {out['bottom_W'][1]} a device; sparse engine "
        f"packed {out['packed'][0]} -> {out['packed'][1]} a device; OK"
    )
    return out


def main(args=None):
    p = argparse.ArgumentParser(description="dry run of the pecos_tpu_torch device mesh")
    p.add_argument("n_devices", type=int, nargs="?", default=8)
    p.add_argument("--device", default="cuda", help="cpu: the CPU repeated; cuda: the first n cards, or card 0 n times")
    a = p.parse_args(args)
    dryrun(make_mesh(devices=["cpu"] * a.n_devices if a.device == "cpu" else cuda_devices(a.n_devices)))


if __name__ == "__main__":
    main()
