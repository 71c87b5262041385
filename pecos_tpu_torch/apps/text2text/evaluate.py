"""CLI: precision and recall at 1..k of Text2Text predictions.

Compares the json lines of ``predict`` with the true labels of an XMC text
file (``labels\\ttext``), items matched by their text.  Host only.

Usage:
    python -m pecos_tpu_torch.apps.text2text.evaluate -i test.txt -p pred.jsonl -q output_items.txt
"""

import argparse
import json

import numpy as np
import scipy.sparse as smat

from pecos_tpu_torch.utils import smat_util
from pecos_tpu_torch.utils.featurization.text import Preprocessor


def parse_arguments(args=None):
    p = argparse.ArgumentParser(description="pecos_tpu_torch Text2Text evaluation")
    p.add_argument("-i", "--input-text-path", required=True, help="truth file (labels\\ttext)")
    p.add_argument("-p", "--pred-path", required=True, help="json-lines output of predict.py")
    p.add_argument("-q", "--output-item-path", required=True, help="item file (one per line)")
    p.add_argument("-k", "--topk", type=int, default=10)
    return p.parse_args(args)


def main(args=None):
    args = parse_arguments(args)
    with open(args.output_item_path, encoding="utf-8") as f:
        items = [line.rstrip("\n") for line in f]
    item_to_id = {t: i for i, t in enumerate(items)}
    truth = Preprocessor.load_data_from_file(
        args.input_text_path, label_text_path=args.output_item_path
    )["label_matrix"]
    rows, cols, vals = [], [], []
    with open(args.pred_path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            for rank, entry in enumerate(json.loads(line)["data"]):
                j = item_to_id.get(entry["item"])
                if j is not None:
                    rows.append(i)
                    cols.append(j)
                    vals.append(float(entry["score"]))
    P = smat.csr_matrix(
        (np.array(vals, np.float32), (rows, cols)), shape=truth.shape
    )
    print(smat_util.Metrics.generate(truth, P, topk=args.topk))


if __name__ == "__main__":
    main()
