"""The JAX package's Text2Text on chip_smoke.py's phase-13b files: the
reference test P@1 / P@5 that ``chip_smoke.T2T_REF_PREC`` records.

It draws the corpus of ``scripts/tokenizer_bench.py`` at phase 13's protocol,
checks its digest against ``chip_smoke.T2T_DIGEST``, writes the item, train
and test files with ``chip_smoke.make_t2t_files``, trains ``pecos_tpu``'s
Text2Text with ``chip_smoke.T2T_TRAIN`` on the CPU, and scores the test
lines by :func:`plain_predict`: a beam search over the saved members' host
matrices in numpy/scipy, with the JAX package's own PostProcessor,
``ClusterChain.padded_children``, ``CsrEnsembler`` and ``sorted_csr``.  The
JAX package's own predict cannot run at this geometry: its XLA form of K1
over plabel rows padded to ~150,000 slots asks for terabytes (ROADMAP F10).
Nothing here imports ``pecos_tpu_torch``.

    JAX_PLATFORMS=cpu python tests/text2text_reference.py --workdir DIR [--model-folder DIR]

``--model-folder`` scores an already trained folder instead of training one.
The last line printed is a JSON object with P@1 .. P@10.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import scipy.sparse as smat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def plain_xlinear_predict(xlm, X, beam_size, only_topk, block=2048):
    """The beam search of a ``pecos_tpu`` XLinearModel over its host
    matrices: each level's raw scores are one sparse product X @ W, then the
    level's transform, the combiner with the parent's path value, and a
    stable descending sort of the candidates in children-table order, the
    lower index first among ties as ``lax.top_k`` takes them.  Returns the
    top-``only_topk`` CSR, each row in rank order."""
    from pecos_tpu.utils import smat_util
    from pecos_tpu.utils.cluster_util import ClusterChain
    from pecos_tpu.xmc.postprocessor import PostProcessor

    chain = xlm.model.model_chain
    pps = [PostProcessor.get(q.post_processor) for q in xlm.model.pred_params.model_chain]
    X = X.tocsr().astype(np.float32)
    if chain[0].bias > 0:
        X = smat.hstack([X, smat.csr_matrix(np.full((X.shape[0], 1), chain[0].bias, np.float32))], format="csr")
    Ws = [m.W.tocsc().astype(np.float32) for m in chain]
    cluster_chain = ClusterChain([m.C for m in chain])
    kids = [cluster_chain.padded_children(d)[0].astype(np.int64) for d in range(len(chain))]
    labels, values = [], []
    for s in range(0, X.shape[0], block):
        xb = X[s : s + block]
        n = xb.shape[0]
        parents = np.tile(np.arange(kids[0].shape[0]), (n, 1))
        pvals = np.full(parents.shape, pps[0].init_value, np.float32)
        for d, (W, children, pp) in enumerate(zip(Ws, kids, pps)):
            raw = (xb @ W).toarray()
            maxc = children.shape[1]
            cand = children[np.clip(parents, 0, None)].reshape(n, -1)
            valid = (cand >= 0) & np.repeat(parents >= 0, maxc, axis=1)
            val = pp.transform_np(np.take_along_axis(raw, np.clip(cand, 0, None), axis=1))
            if d:
                val = pp.combiner_np(val, np.repeat(pvals, maxc, axis=1))
            val = np.where(valid, val, -np.inf).astype(np.float32)
            k = min(only_topk if d == len(Ws) - 1 else beam_size, cand.shape[1])
            order = np.argsort(-val, axis=1, kind="stable")[:, :k]
            pvals = np.take_along_axis(val, order, axis=1)
            parents = np.where(pvals > -np.inf, np.take_along_axis(cand, order, axis=1), -1)
        labels.append(parents)
        values.append(np.where(parents >= 0, pvals, 0.0))
    return smat_util.csr_from_topk_arrays(np.concatenate(labels), np.concatenate(values), Ws[-1].shape[1])


def plain_predict(model, texts, topk, beam_size):
    """``pecos_tpu`` Text2Text.predict(texts, ret_csr=True) with each
    member's beam search replaced by :func:`plain_xlinear_predict`.  Raises
    if a text has no known n-gram: the JAX package's Tfidf predict then
    numbers the later rows wrongly (ROADMAP F9)."""
    from pecos_tpu.utils import smat_util

    X = model.preprocessor.predict(list(texts))
    if X.shape[0] != len(texts) or (np.diff(X.tocsr().indptr) == 0).any():
        raise RuntimeError("a text without a known n-gram: the JAX package's Tfidf rows would be misnumbered")
    preds = [plain_xlinear_predict(m, X, beam_size, max(topk, 10)) for m in model.xlinear_models]
    P = preds[0] if len(preds) == 1 else getattr(smat_util.CsrEnsembler, model.ens_method)(*preds)
    return smat_util.sorted_csr(P.tocsr(), only_topk=topk)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workdir", required=True, help="folder for the item, train and test files")
    parser.add_argument("--model-folder", default=None, help="score this trained folder instead of training")
    args = parser.parse_args(argv)

    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke as cs
    from pecos_tpu.apps.text2text import Text2Text
    from pecos_tpu.utils import smat_util
    from pecos_tpu.utils.featurization.text import Preprocessor

    corpus = cs.load_script("tokenizer_bench").make_corpus(**cs.T2T_CORPUS)
    digest = cs.corpus_digest(corpus)
    if digest != cs.T2T_DIGEST:
        raise RuntimeError(f"corpus digest {digest}, not {cs.T2T_DIGEST}: this numpy draws another corpus")
    os.makedirs(args.workdir, exist_ok=True)
    items, trn, tst = cs.make_t2t_files(args.workdir, corpus)
    folder = args.model_folder
    if folder is None:
        t0 = time.perf_counter()
        model = Text2Text.train(trn, items, **cs.T2T_TRAIN)
        print(f"train: {time.perf_counter() - t0!r} s", flush=True)
        folder = os.path.join(args.workdir, "jax_model")
        model.save(folder)
    model = Text2Text.load(folder)
    parsed = Preprocessor.load_data_from_file(tst, label_text_path=items)
    t0 = time.perf_counter()
    P = plain_predict(model, parsed["corpus"], cs.T2T_TOPK, cs.T2T_BEAM)
    print(f"predict: {time.perf_counter() - t0!r} s for {P.shape[0]} test lines", flush=True)
    m = smat_util.Metrics.generate(parsed["label_matrix"], P, topk=cs.T2T_TOPK)
    print(json.dumps({"digest": digest, "prec": m.prec.tolist(), "recall": m.recall.tolist()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
