"""CLI: distributed XR-Linear training.

The flags of ``pecos_tpu.distributed.xmc.xlinear.train``, with ``--device``
in place of ``--multihost``.  One process trains alone (``DummyComm``):

    python -m pecos_tpu_torch.distributed.xmc.xlinear.train -x X.npz -y Y.npz -m out_dir [--device cuda]

Under ``torchrun`` (WORLD_SIZE > 1 in the environment) each process joins a
``torch.distributed`` group, NCCL for ``--device cuda`` (rank r on card
LOCAL_RANK) and gloo for ``--device cpu``, and the ranks talk through
``MultihostComm``; rank 0 writes the model:

    torchrun --nproc-per-node 2 -m pecos_tpu_torch.distributed.xmc.xlinear.train -x X.npz -y Y.npz -m out_dir --device cpu
"""

import argparse
import os

import torch
import torch.distributed as dist

from pecos_tpu_torch.parallel.comm import DummyComm, MultihostComm
from pecos_tpu_torch.utils import smat_util
from pecos_tpu_torch.utils.logging_util import setup_logging_config
from .model import DistributedXLinearModel


def parse_arguments(args=None):
    p = argparse.ArgumentParser(description="pecos_tpu_torch distributed XR-Linear training")
    p.add_argument("-x", "--inst-path", required=True)
    p.add_argument("-y", "--label-path", required=True)
    p.add_argument("-m", "--model-folder", required=True)
    p.add_argument("--nr-splits", type=int, default=16)
    p.add_argument("--max-leaf-size", type=int, default=100)
    p.add_argument("--min-n-sub-tree", type=int, default=None)
    p.add_argument("--main-workload-factor", type=float, default=0.3)
    p.add_argument("--verbose-level", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda", help="torch device: cuda (default) or cpu")
    return p.parse_args(args)


def main(args=None):
    args = parse_arguments(args)
    setup_logging_config(args.verbose_level)
    device = torch.device(args.device)
    own_group = int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized()
    if own_group:
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
            torch.cuda.set_device(device)
        dist.init_process_group(backend="nccl" if device.type == "cuda" else "gloo")
    try:
        comm = MultihostComm() if dist.is_initialized() else DummyComm()
        model = DistributedXLinearModel.train(
            smat_util.load_feature_matrix(args.inst_path),
            smat_util.load_label_matrix(args.label_path),
            comm,
            cluster_params={"indexer_params": {"nr_splits": args.nr_splits, "max_leaf_size": args.max_leaf_size}},
            train_params={"main_workload_factor": args.main_workload_factor, "min_n_sub_tree": args.min_n_sub_tree},
            device=device,
        )
        if model is not None:
            model.save(args.model_folder)
    finally:
        if own_group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
