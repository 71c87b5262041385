"""CLI: train Text2Text on a torch device.

Usage:
    python -m pecos_tpu_torch.apps.text2text.train -i input.txt -q output_items.txt -m model_dir [--device cuda]
"""

import argparse

from pecos_tpu_torch.utils.logging_util import setup_logging_config
from .model import Text2Text


def parse_arguments(args=None):
    p = argparse.ArgumentParser(description="pecos_tpu_torch Text2Text training")
    p.add_argument("-i", "--input-text-path", required=True)
    p.add_argument("-q", "--output-item-path", required=True)
    p.add_argument("-m", "--model-folder", required=True)
    p.add_argument("--workspace-folder", default=None)
    p.add_argument("--label-embed-type", default="pifa", help="comma-separated methods")
    p.add_argument("--ensemble-seeds", default="0", help="comma-separated seeds")
    p.add_argument("--ens-method", default="average",
                   choices=["average", "rank_average", "sigmoid_average", "softmax_average", "round_robin"])
    p.add_argument("--max-leaf-size", type=int, default=100)
    p.add_argument("--nr-splits", type=int, default=16)
    p.add_argument("-t", "--threshold", type=float, default=0.1)
    p.add_argument("-b", "--beam-size", type=int, default=10)
    p.add_argument("--verbose-level", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda", help="torch device: cuda (default) or cpu")
    return p.parse_args(args)


def main(args=None):
    args = parse_arguments(args)
    setup_logging_config(args.verbose_level)
    model = Text2Text.train(
        args.input_text_path,
        args.output_item_path,
        label_embed_type=[s.strip() for s in args.label_embed_type.split(",")],
        ensemble_seeds=[int(s) for s in args.ensemble_seeds.split(",")],
        ens_method=args.ens_method,
        indexer_kwargs={"max_leaf_size": args.max_leaf_size, "nr_splits": args.nr_splits},
        xlinear_kwargs={"threshold": args.threshold},
        workspace_folder=args.workspace_folder,
        device=args.device,
    )
    model.save(args.model_folder)


if __name__ == "__main__":
    main()
