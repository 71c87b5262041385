"""CLI: text embeddings from a trained XR-Transformer on a torch device.

Usage:
    python -m pecos_tpu_torch.xmc.xtransformer.encode -t text.txt -m model_dir -o emb.npy [--device cuda]
"""

import argparse

import numpy as np

from .model import XTransformer


def parse_arguments(args=None):
    p = argparse.ArgumentParser(description="pecos_tpu_torch XR-Transformer encoding")
    p.add_argument("-t", "--txt-path", required=True)
    p.add_argument("-m", "--model-folder", required=True)
    p.add_argument("-o", "--save-emb-path", required=True)
    p.add_argument("--device", type=str, default="cuda", help="torch device: cuda (default) or cpu")
    return p.parse_args(args)


def main(args=None):
    args = parse_arguments(args)
    with open(args.txt_path, encoding="utf-8") as f:
        corpus = [line.rstrip("\n") for line in f]
    emb = XTransformer.load(args.model_folder, device=args.device).encode(corpus)
    path = args.save_emb_path
    np.save(path if path.endswith(".npy") else path + ".npy", emb)


if __name__ == "__main__":
    main()
