"""CLI: precision and recall at 1..k of saved predictions against truth labels.

Usage:
    python -m pecos_tpu_torch.xmc.xlinear.evaluate -y Yt.npz -p Yt_pred.npz -k 10
"""

import argparse

from pecos_tpu_torch.utils import smat_util


def parse_arguments(args=None):
    p = argparse.ArgumentParser(description="pecos_tpu_torch XMC evaluation")
    p.add_argument("-y", "--truth-path", type=str, required=True, metavar="PATH")
    p.add_argument("-p", "--pred-path", type=str, required=True, metavar="PATH")
    p.add_argument("-k", "--topk", type=int, default=10)
    return p.parse_args(args)


def main(args=None):
    args = parse_arguments(args)
    Y = smat_util.load_label_matrix(args.truth_path)
    P = smat_util.load_matrix(args.pred_path)
    print(smat_util.Metrics.generate(Y, P, topk=args.topk))


if __name__ == "__main__":
    main()
