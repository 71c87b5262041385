"""CLI: train XR-Transformer on a torch device.

Usage:
    python -m pecos_tpu_torch.xmc.xtransformer.train -t input.txt -x X.npz -y Y.npz -m model_dir [--device cuda]
"""

import argparse
import json

from pecos_tpu_torch.utils import smat_util
from pecos_tpu_torch.utils.logging_util import setup_logging_config
from .matcher import TransformerMatcher
from .model import XTransformer
from .module import MLProblemWithText


def parse_arguments(args=None):
    p = argparse.ArgumentParser(description="pecos_tpu_torch XR-Transformer training")
    p.add_argument("--generate-params-skeleton", action="store_true")
    p.add_argument("--params-path", type=str, default=None)
    p.add_argument("-t", "--trn-text-path", type=str, help="one text per line")
    p.add_argument("-x", "--trn-feat-path", type=str, default=None)
    p.add_argument("-y", "--trn-label-path", type=str)
    p.add_argument("-m", "--model-dir", type=str)
    p.add_argument("--model-shortcut", type=str, default="distilbert-base-uncased")
    p.add_argument("--model-type", type=str, default="distilbert")
    p.add_argument("--truncate-length", type=int, default=128)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--learning-rate", type=float, default=5e-5)
    p.add_argument("--num-train-epochs", type=int, default=1)
    p.add_argument("--max-match-clusters", type=int, default=32768)
    p.add_argument("--verbose-level", type=int, default=2)
    p.add_argument("--device", type=str, default="cuda", help="torch device: cuda (default) or cpu")
    return p.parse_args(args)


def main(args=None):
    args = parse_arguments(args)
    if args.generate_params_skeleton:
        skeleton = {
            "train_params": XTransformer.TrainParams(matcher_params_chain=TransformerMatcher.TrainParams()).to_dict(),
            "pred_params": XTransformer.PredParams().to_dict(),
        }
        print(json.dumps(skeleton, indent=2))
        return
    setup_logging_config(args.verbose_level)
    with open(args.trn_text_path, encoding="utf-8") as f:
        corpus = [line.rstrip("\n") for line in f]
    Y = smat_util.load_label_matrix(args.trn_label_path)
    X_feat = smat_util.load_feature_matrix(args.trn_feat_path) if args.trn_feat_path else None
    train_params = None
    if args.params_path:
        with open(args.params_path) as f:
            train_params = json.load(f).get("train_params")
    if train_params is None:
        train_params = XTransformer.TrainParams(
            max_match_clusters=args.max_match_clusters,
            matcher_params_chain=TransformerMatcher.TrainParams(
                model_shortcut=args.model_shortcut,
                model_type=args.model_type,
                truncate_length=args.truncate_length,
                batch_size=args.batch_size,
                learning_rate=args.learning_rate,
                num_train_epochs=args.num_train_epochs,
            ),
        )
    model = XTransformer.train(MLProblemWithText(corpus, Y, X_feat=X_feat), train_params=train_params, device=args.device)
    model.save(args.model_dir)


if __name__ == "__main__":
    main()
