"""CLI: build an HNSW index on a torch device.

The flags of ``pecos_tpu.ann.hnsw.train``, plus ``--device``.

Usage:
    python -m pecos_tpu_torch.ann.hnsw.train -x X.npz -m model_dir [--metric-type l2] [--device cuda]
"""

import argparse
import logging
import os

from pecos_tpu_torch.utils import smat_util
from pecos_tpu_torch.utils.logging_util import setup_logging_config
from .model import HNSW


def parse_arguments(args=None):
    p = argparse.ArgumentParser(description="pecos_tpu_torch HNSW index build")
    p.add_argument("-x", "--inst-path", type=str, required=True, metavar="PATH",
                   help="CSR npz or row-major npy item matrix (nr_items x nr_feats) to index")
    p.add_argument("-m", "--model-folder", type=str, required=True, metavar="DIR", help="folder to save the index into")
    p.add_argument("--metric-type", type=str, default="ip", metavar="STR", help="ip (inner product, default) or l2")
    p.add_argument("-M", "--max-edge-per-node", type=int, default=32, metavar="INT",
                   help="max edges per node on levels >= 1; level 0 gets 2*M (default 32)")
    p.add_argument("-efC", "--efConstruction", type=int, default=100, metavar="INT", help="build beam width (default 100)")
    p.add_argument("-n", "--threads", type=int, default=-1, metavar="INT", help="accepted for parity; unused")
    p.add_argument("-L", "--max-level-upper-bound", type=int, default=-1, metavar="INT",
                   help="max number of graph levels (-1: default bound)")
    p.add_argument("--refine-iters", type=int, default=1, metavar="INT", help="graph-repair passes (default 1)")
    p.add_argument("-efS", "--efSearch", type=int, default=100, metavar="INT", help="default search beam stored in the model")
    p.add_argument("-k", "--only-topk", type=int, default=10, metavar="INT", help="default top-k stored in the model")
    p.add_argument("--verbose-level", type=int, default=1, metavar="INT", help="logging verbosity 0-3")
    p.add_argument("--device", type=str, default="cuda", help="torch device: cuda (default) or cpu")
    return p.parse_args(args)


def do_train(args):
    setup_logging_config(level=args.verbose_level)
    os.makedirs(args.model_folder, exist_ok=True)
    X = smat_util.load_matrix(args.inst_path)
    train_params = HNSW.TrainParams(
        M=args.max_edge_per_node, efC=args.efConstruction, metric_type=args.metric_type,
        threads=args.threads, refine_iters=args.refine_iters,
    )
    if args.max_level_upper_bound >= 0:
        train_params.max_level_upper_bound = args.max_level_upper_bound
    pred_params = HNSW.PredParams(efS=args.efSearch, topk=args.only_topk, threads=args.threads)
    model = HNSW.train(X, train_params=train_params, pred_params=pred_params, device=args.device)
    model.save(args.model_folder)
    logging.getLogger(__name__).info("saved HNSW model to %s", args.model_folder)


def main(args=None):
    do_train(parse_arguments(args))


if __name__ == "__main__":
    main()
