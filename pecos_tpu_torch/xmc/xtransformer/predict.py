"""CLI: XR-Transformer prediction on a torch device.

Usage:
    python -m pecos_tpu_torch.xmc.xtransformer.predict -t test.txt [-x Xt.npz] -m model_dir -o P.npz [--device cuda]
"""

import argparse

from pecos_tpu_torch.utils import smat_util
from .model import XTransformer


def parse_arguments(args=None):
    p = argparse.ArgumentParser(description="pecos_tpu_torch XR-Transformer prediction")
    p.add_argument("-t", "--txt-path", required=True)
    p.add_argument("-x", "--feat-path", default=None)
    p.add_argument("-m", "--model-folder", required=True)
    p.add_argument("-o", "--save-pred-path", required=True)
    p.add_argument("-k", "--only-topk", type=int, default=None)
    p.add_argument("-b", "--beam-size", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda", help="torch device: cuda (default) or cpu")
    return p.parse_args(args)


def main(args=None):
    args = parse_arguments(args)
    with open(args.txt_path, encoding="utf-8") as f:
        corpus = [line.rstrip("\n") for line in f]
    X_feat = smat_util.load_feature_matrix(args.feat_path) if args.feat_path else None
    model = XTransformer.load(args.model_folder, device=args.device)
    kwargs = {k: v for k, v in (("only_topk", args.only_topk), ("beam_size", args.beam_size)) if v}
    smat_util.save_matrix(args.save_pred_path, model.predict(corpus, X_feat=X_feat, **kwargs))


if __name__ == "__main__":
    main()
