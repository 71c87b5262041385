"""The toy text-in kind's work: the ranker's, over the concatenated rows
(each query's TF-IDF nonzeros and H embedding columns), counted by
``xrlinear_work``; the toy's embedding is not counted."""

from __future__ import annotations

from typing import Dict

import numpy as np

# k1_levels and leaf_spread are the XR-Linear kind's: the toy ranks with XR-Linear
from portbench.models.xrlinear_work import k1_levels, leaf_spread, traced_work  # noqa: F401
from portbench.tests import toytext


def traced(ref, model, traced_queries, cfg: Dict, peaks: Dict) -> Dict[str, object]:
    beams = ref.beam_search(toytext.stack(traced_queries), keep_beams=True)["beams"]
    children = [ref.children[d].cpu().numpy() for d in range(ref.depth)]
    real = [(v != 0).sum(axis=1) for v in model.vals]
    H = model.D - model.text_features
    batches, s = [], 0
    for q in traced_queries:
        n = q.shape[0]
        batches.append((np.diff(q.X.indptr) + H, [b[s : s + n] for b in beams]))
        s += n
    return traced_work(batches, children, real, k1_levels(model.D, model.sizes), int(cfg["only_topk"]), peaks)
