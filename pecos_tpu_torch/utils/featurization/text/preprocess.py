"""Preprocessor: text corpus -> feature matrix (+ label matrix from an XMC text file).

The port of ``pecos_tpu/utils/featurization/text/preprocess.py``: a trained
Vectorizer, the ``label_ids\\ttext`` file parser, and the CLI

    python -m pecos_tpu_torch.utils.featurization.text.preprocess build -i corpus.txt -m model_dir
    python -m pecos_tpu_torch.utils.featurization.text.preprocess run -i corpus.txt -m model_dir -x X.npz

(``--from-xmc-file`` reads ``label_ids\\ttext`` lines; ``run -y Y.npz`` also
writes their label matrix).  Host only: the folder format is the JAX
package's.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np
import scipy.sparse as smat

import pecos_tpu_torch
from pecos_tpu_torch.utils import smat_util
from .vectorizers import Vectorizer


class Preprocessor(pecos_tpu_torch.BaseClass):
    """Trainable text preprocessor wrapping a Vectorizer."""

    def __init__(self, vectorizer: Vectorizer):
        self.vectorizer = vectorizer

    @classmethod
    def train(cls, trn_corpus, vectorizer_config: Optional[dict] = None, dtype=np.float32):
        return cls(Vectorizer.train(trn_corpus, config=vectorizer_config, dtype=dtype))

    def predict(self, corpus, **kwargs) -> smat.csr_matrix:
        return self.vectorizer.predict(corpus, **kwargs)

    def save(self, folder):
        os.makedirs(folder, exist_ok=True)
        self.vectorizer.save(os.path.join(folder, "vectorizer"))

    @classmethod
    def load(cls, folder):
        return cls(Vectorizer.load(os.path.join(folder, "vectorizer")))

    # -- corpus file parsing ------------------------------------------------------
    @staticmethod
    def load_data_from_file(
        src: str, label_text_path: Optional[str] = None, text_pos: int = 1
    ) -> dict:
        """Parse an XMC text file: each line ``l1,l2,...\\ttext``.

        Returns a dict with 'corpus' (list of str, the ``text_pos``-th tab
        field of each line) and 'label_matrix' (csr, one column per label id,
        at least as many as ``label_text_path`` has lines).
        """
        corpus: List[str] = []
        rows: List[int] = []
        cols: List[int] = []
        with open(src, encoding="utf-8") as f:
            for i, line in enumerate(f):
                line = line.rstrip("\n")
                if not line:
                    corpus.append("")
                    continue
                parts = line.split("\t")
                labels = parts[0]
                text = parts[text_pos] if len(parts) > text_pos else ""
                corpus.append(text)
                if labels:
                    for tok in labels.split(","):
                        tok = tok.strip()
                        if tok:
                            rows.append(i)
                            cols.append(int(tok))
        nr_labels = max(cols) + 1 if cols else 0
        if label_text_path is not None:
            with open(label_text_path, encoding="utf-8") as f:
                nr_labels = max(nr_labels, sum(1 for _ in f))
        Y = smat.csr_matrix(
            (np.ones(len(rows), np.float32), (rows, cols)),
            shape=(len(corpus), nr_labels),
        )
        return {"corpus": corpus, "label_matrix": Y}


def main(args=None):
    p = argparse.ArgumentParser(description="pecos_tpu_torch text preprocessing")
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="train a vectorizer from a corpus")
    b.add_argument("-i", "--input-text-path", required=True)
    b.add_argument("-m", "--model-folder", required=True)
    b.add_argument("--vectorizer-config-path", default=None)
    b.add_argument("--text-pos", type=int, default=1)
    b.add_argument("--from-xmc-file", action="store_true", help="input is label\\ttext format")

    r = sub.add_parser("run", help="vectorize a corpus with a trained model")
    r.add_argument("-i", "--input-text-path", required=True)
    r.add_argument("-m", "--model-folder", required=True)
    r.add_argument("-x", "--output-inst-path", required=True)
    r.add_argument("-y", "--output-label-path", default=None)
    r.add_argument("--text-pos", type=int, default=1)
    r.add_argument("--from-xmc-file", action="store_true")

    a = p.parse_args(args)
    if a.cmd == "build":
        if a.from_xmc_file:
            corpus = Preprocessor.load_data_from_file(a.input_text_path, text_pos=a.text_pos)["corpus"]
        else:
            corpus = a.input_text_path
        config = None
        if a.vectorizer_config_path:
            with open(a.vectorizer_config_path) as f:
                config = json.load(f)
        pre = Preprocessor.train(corpus, vectorizer_config=config)
        pre.save(a.model_folder)
    elif a.cmd == "run":
        pre = Preprocessor.load(a.model_folder)
        if a.from_xmc_file:
            parsed = Preprocessor.load_data_from_file(a.input_text_path, text_pos=a.text_pos)
            corpus = parsed["corpus"]
            if a.output_label_path:
                smat_util.save_matrix(a.output_label_path, parsed["label_matrix"])
        else:
            corpus = a.input_text_path
        X = pre.predict(corpus)
        smat_util.save_matrix(a.output_inst_path, X)


if __name__ == "__main__":
    main()
