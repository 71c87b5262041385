"""CLI: Text2Text prediction on a torch device.

Reads text lines (``labels\\ttext`` or plain text) and writes one json line
per input, ``{"data": [{"item": ..., "score": ...}, ...]}``.

Usage:
    python -m pecos_tpu_torch.apps.text2text.predict -i input.txt -m model_dir -o pred.jsonl [--device cuda]
"""

import argparse
import json
import sys

from .model import Text2Text


def parse_arguments(args=None):
    p = argparse.ArgumentParser(description="pecos_tpu_torch Text2Text prediction")
    p.add_argument("-i", "--input-text-path", required=True)
    p.add_argument("-m", "--model-folder", required=True)
    p.add_argument("-o", "--predicted-output-item-path", default=None)
    p.add_argument("-k", "--topk", type=int, default=10)
    p.add_argument("-b", "--beam-size", type=int, default=None)
    p.add_argument("--text-pos", type=int, default=1, help="column of text in tab-split lines (0 = whole line)")
    p.add_argument("--device", type=str, default="cuda", help="torch device: cuda (default) or cpu")
    return p.parse_args(args)


def main(args=None):
    args = parse_arguments(args)
    model = Text2Text.load(args.model_folder, device=args.device)
    corpus = []
    with open(args.input_text_path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            corpus.append(parts[args.text_pos] if len(parts) > args.text_pos else parts[-1])
    kwargs = {"beam_size": args.beam_size} if args.beam_size else {}
    results = model.predict(corpus, topk=args.topk, **kwargs)
    out = open(args.predicted_output_item_path, "w", encoding="utf-8") if args.predicted_output_item_path else sys.stdout
    try:
        for items in results:
            out.write(json.dumps({"data": [{"item": it, "score": sc} for it, sc in items]}) + "\n")
    finally:
        if out is not sys.stdout:
            out.close()


if __name__ == "__main__":
    main()
