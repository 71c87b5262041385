"""CLI: predict with a trained XR-Linear model on a torch device.

Usage:
    python -m pecos_tpu_torch.xmc.xlinear.predict -x Xt.npz -m model_dir -o Yt_pred.npz [--device cuda]
"""

import argparse

from pecos_tpu_torch.utils import smat_util
from pecos_tpu_torch.utils.logging_util import setup_logging_config
from .model import XLinearModel


def parse_arguments(args=None):
    p = argparse.ArgumentParser(description="pecos_tpu_torch XR-Linear prediction")
    p.add_argument("-x", "--inst-path", type=str, required=True, metavar="PATH")
    p.add_argument("-m", "--model-folder", type=str, required=True, metavar="DIR")
    p.add_argument("-o", "--save-pred-path", type=str, required=True, metavar="PATH")
    p.add_argument("-y", "--label-path", type=str, default=None, metavar="PATH", help="optional truth labels; prints P@k/R@k")
    p.add_argument("-b", "--beam-size", type=int, default=None)
    p.add_argument("-k", "--only-topk", type=int, default=None)
    p.add_argument("-pp", "--post-processor", type=str, default=None)
    p.add_argument("--verbose-level", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda", help="torch device: cuda (default) or cpu")
    return p.parse_args(args)


def do_predict(args):
    setup_logging_config(args.verbose_level)
    X = smat_util.load_feature_matrix(args.inst_path)
    model = XLinearModel.load(args.model_folder, device=args.device)
    kwargs = {
        k: v
        for k, v in (
            ("beam_size", args.beam_size),
            ("only_topk", args.only_topk),
            ("post_processor", args.post_processor),
        )
        if v is not None
    }
    P = model.predict(X, **kwargs)
    smat_util.save_matrix(args.save_pred_path, P)
    if args.label_path:
        Y = smat_util.load_label_matrix(args.label_path)
        print(smat_util.Metrics.generate(Y, P, topk=10))


def main(args=None):
    do_predict(parse_arguments(args))


if __name__ == "__main__":
    main()
