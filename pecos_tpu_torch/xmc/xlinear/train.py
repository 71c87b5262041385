"""CLI: train an XR-Linear model on a torch device.

The flags of ``pecos_tpu.xmc.xlinear.train``, plus ``--device``.  A params
file (``--params-path``) written by either package's
``--generate-params-skeleton`` is read.

Usage:
    python -m pecos_tpu_torch.xmc.xlinear.train -x X.npz -y Y.npz -m model_dir [--device cuda]
"""

import argparse
import json
import os
import sys

from pecos_tpu_torch.utils import smat_util
from pecos_tpu_torch.utils.cluster_util import ClusterChain
from pecos_tpu_torch.utils.logging_util import setup_logging_config
from pecos_tpu_torch.xmc import HierarchicalMLModel, Indexer, LabelEmbeddingFactory, MLModel
from .model import XLinearModel


def parse_arguments(args=None):
    p = argparse.ArgumentParser(description="pecos_tpu_torch XR-Linear training")
    p.add_argument("--generate-params-skeleton", action="store_true", dest="generate_params_skeleton")
    p.add_argument("--params-path", type=str, default=None, metavar="PARAMS_PATH")
    p.add_argument("-x", "--inst-path", type=str, metavar="PATH", help="instance feature matrix (npz/npy)")
    p.add_argument("-y", "--label-path", type=str, metavar="PATH", help="label matrix (npz)")
    p.add_argument("-m", "--model-folder", type=str, metavar="DIR", help="output model folder")
    p.add_argument("-f", "--label-feat-path", type=str, default=None, metavar="PATH", help="label feature matrix for clustering (default: PIFA from X, Y)")
    p.add_argument("-c", "--code-path", type=str, default=None, metavar="PATH", help="pre-built cluster chain (dir saved by ClusterChain.save or npz)")
    p.add_argument("-r", "--rel-path", type=str, default=None, metavar="PATH", help="relevance matrix for cost-sensitive learning (npz)")
    p.add_argument("--nr-splits", type=int, default=16)
    p.add_argument("--max-leaf-size", type=int, default=100)
    p.add_argument("--spherical", type=lambda s: s.lower() not in ("0", "false"), default=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--kmeans-max-iter", type=int, default=20)
    p.add_argument("--label-embed-type", type=str, default="pifa", choices=["pifa", "pii"])
    p.add_argument("-s", "--solver-type", type=str, default="L2R_L2LOSS_SVC_DUAL")
    p.add_argument("--Cp", type=float, default=1.0)
    p.add_argument("--Cn", type=float, default=1.0)
    p.add_argument("--bias", type=float, default=1.0)
    p.add_argument("-t", "--threshold", type=float, default=0.1)
    p.add_argument("-ns", "--negative-sampling", type=str, default="tfn", dest="negative_sampling")
    p.add_argument("-b", "--beam-size", type=int, default=10)
    p.add_argument("-k", "--only-topk", type=int, default=20)
    p.add_argument("-pp", "--post-processor", type=str, default="l3-hinge")
    p.add_argument("--rel-mode", type=str, default="disable")
    p.add_argument("--rel-norm", type=str, default="no-norm")
    p.add_argument("--verbose-level", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda", help="torch device: cuda (default) or cpu")
    return p.parse_args(args)


def params_skeleton() -> dict:
    return {
        "train_params": XLinearModel.TrainParams(
            hlm_args=HierarchicalMLModel.TrainParams(neg_mining_chain="tfn", model_chain=(MLModel.TrainParams(),))
        ).to_dict(),
        "pred_params": XLinearModel.PredParams(
            hlm_args=HierarchicalMLModel.PredParams(model_chain=(MLModel.PredParams(),))
        ).to_dict(),
        "indexer_params": Indexer.indexer_dict["hierarchicalkmeans"].TrainParams().to_dict(),
    }


def do_train(args) -> None:
    setup_logging_config(args.verbose_level)
    X = smat_util.load_feature_matrix(args.inst_path)
    Y = smat_util.load_label_matrix(args.label_path)
    R = smat_util.load_matrix(args.rel_path) if args.rel_path else None
    params = {}
    if args.params_path:
        with open(args.params_path) as f:
            params = json.load(f)

    if args.code_path and os.path.isdir(args.code_path):
        chain = ClusterChain.load(args.code_path)
    elif args.code_path:
        chain = ClusterChain.from_partial_chain(smat_util.load_matrix(args.code_path), nr_splits=args.nr_splits)
    else:
        if args.label_feat_path:
            label_feat = smat_util.load_matrix(args.label_feat_path)
        else:
            label_feat = LabelEmbeddingFactory.create(Y, X, method=args.label_embed_type)
        indexer_params = params.get("indexer_params") or dict(
            nr_splits=args.nr_splits, max_leaf_size=args.max_leaf_size, spherical=args.spherical,
            seed=args.seed, kmeans_max_iter=args.kmeans_max_iter,
        )
        chain = Indexer.gen(label_feat, train_params=indexer_params, device=args.device)

    train_params = params.get("train_params")
    kwargs = {}
    if train_params is None:
        kwargs = dict(
            solver_type=args.solver_type, Cp=args.Cp, Cn=args.Cn, bias=args.bias, threshold=args.threshold,
            negative_sampling_scheme=args.negative_sampling, rel_mode=args.rel_mode, rel_norm=args.rel_norm,
        )
    kwargs["pred_kwargs"] = dict(beam_size=args.beam_size, only_topk=args.only_topk, post_processor=args.post_processor)
    xlm = XLinearModel.train(
        X, Y, C=chain, R=R, train_params=train_params, pred_params=params.get("pred_params"),
        device=args.device, **kwargs,
    )
    xlm.save(args.model_folder)


def main(args=None):
    args = parse_arguments(args)
    if args.generate_params_skeleton:
        print(json.dumps(params_skeleton(), indent=2))
        return
    if not (args.inst_path and args.label_path and args.model_folder):
        print("error: -x, -y, -m are required (or --generate-params-skeleton)", file=sys.stderr)
        sys.exit(2)
    do_train(args)


if __name__ == "__main__":
    main()
