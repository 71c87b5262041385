"""CLI: search an HNSW index on a torch device.

The flags of ``pecos_tpu.ann.hnsw.predict``, plus ``--device``: optionally
saves the prediction CSR and prints Recall@k against a ground-truth matrix.

Usage:
    python -m pecos_tpu_torch.ann.hnsw.predict -x Xt.npz -m model_dir [-y Y.npz] [-o pred.npz] [--device cuda]
"""

import argparse

from pecos_tpu_torch.utils import smat_util
from pecos_tpu_torch.utils.logging_util import setup_logging_config
from .model import HNSW


def parse_arguments(args=None):
    p = argparse.ArgumentParser(description="pecos_tpu_torch HNSW search")
    p.add_argument("-x", "--inst-path", type=str, required=True, metavar="PATH",
                   help="CSR npz or row-major npy query matrix (nr_queries x nr_feats)")
    p.add_argument("-m", "--model-folder", type=str, required=True, metavar="DIR", help="folder holding the index")
    p.add_argument("-efS", "--efSearch", type=int, default=100, metavar="INT", help="search beam width (default 100)")
    p.add_argument("-k", "--only-topk", type=int, default=10, metavar="INT", help="nearest items to return (default 10)")
    p.add_argument("-n", "--threads", type=int, default=-1, metavar="INT", help="accepted for parity; unused")
    p.add_argument("-y", "--label-path", type=str, default=None, metavar="PATH",
                   help="ground-truth matrix (CSR npz, nr_queries x nr_items) for Recall@k")
    p.add_argument("-o", "--save-pred-path", type=str, default=None, metavar="PATH",
                   help="where to save the prediction CSR (scores -distance)")
    p.add_argument("--verbose-level", type=int, default=1, metavar="INT", help="logging verbosity 0-3")
    p.add_argument("--device", type=str, default="cuda", help="torch device: cuda (default) or cpu")
    return p.parse_args(args)


def do_predict(args):
    setup_logging_config(level=args.verbose_level)
    Xt = smat_util.load_matrix(args.inst_path)
    model = HNSW.load(args.model_folder, device=args.device)
    pred_params = HNSW.PredParams(efS=args.efSearch, topk=args.only_topk, threads=args.threads)
    Yt_pred = model.predict(Xt, pred_params=pred_params, ret_csr=True)
    if args.save_pred_path:
        smat_util.save_matrix(args.save_pred_path, Yt_pred)
    if args.label_path:
        Yt = smat_util.load_label_matrix(args.label_path)
        Yt_topk = smat_util.sorted_csr(Yt, only_topk=args.only_topk)
        metric = smat_util.Metrics.generate(Yt_topk, Yt_pred, topk=args.only_topk)
        print("Recall{}@{} {:.6f}%".format(args.only_topk, args.only_topk, 100.0 * metric.recall[-1]))


def main(args=None):
    do_predict(parse_arguments(args))


if __name__ == "__main__":
    main()
