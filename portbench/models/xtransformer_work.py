"""The operations and bytes that XR-Transformer predict (concat-only) needs,
counted from shapes and from the reference's beam, never from the program's
launches.

- The ranker's: ``xrlinear_work``'s count over the concatenated rows, each
  query's TF-IDF nonzeros and H embedding columns, with the weights' real
  slots over D + H columns.
- The encoder's (``encoder_flops``): the multiply-adds of its dense layers
  and of attention, two operations each, for every one of a text's
  ``truncate_length`` token slots, which the encoder computes whether a slot
  holds a token or padding (``token_pad_share`` reads how many are padding);
  per layer and slot, Q, K, V and the output projection (4 H^2), the
  feed-forward (2 H F) and attention's scores and weighted sum (2 T H); per
  text, the pooler (H^2).  Its bound is those operations at the float32 peak:
  the weights it reads (~0.44 GB a forward of 256 texts) need under 1% of
  that time at the HBM peak, so it is not a bytes bound.
- The whole predict (``mfu``): the two bounds added, the encoder's and then
  the ranker's, since the ranker waits for the embeddings.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

# k1_levels and leaf_spread are the XR-Linear kind's: the concat ranker is XR-Linear
from portbench.models.xrlinear_work import k1_levels, leaf_spread, traced_work  # noqa: F401


def encoder_flops(model_config: Dict, slots: int) -> float:
    """Operations of one text's forward over ``slots`` token slots."""
    H = int(model_config["hidden_size"])
    F = int(model_config["intermediate_size"])
    layers = int(model_config["num_hidden_layers"])
    per_slot = layers * (4 * H * H + 2 * H * F + 2 * slots * H)
    return 2.0 * (slots * per_slot + H * H)


def traced(ref, model, traced_queries, cfg: Dict, peaks: Dict) -> Dict[str, object]:
    """The work of the traced batches (pool slices, one a batch)."""
    from portbench.models import xtransformer

    beams = ref.beam_search(xtransformer.stack(traced_queries), keep_beams=True)["beams"]
    children = [ref.children[d].cpu().numpy() for d in range(ref.depth)]
    real = [(v != 0).sum(axis=1) for v in model.vals]
    H = model.D - model.text_features
    batches, s = [], 0
    for q in traced_queries:
        n = q.shape[0]
        batches.append((np.diff(q.X.indptr) + H, [b[s : s + n] for b in beams]))
        s += n
    work = traced_work(batches, children, real, k1_levels(model.D, model.sizes), int(cfg["only_topk"]), peaks)
    texts = s
    per_text = encoder_flops(cfg["model_config"], int(cfg["truncate_length"]))
    ops = texts * per_text
    enc = {"seconds": ops / float(peaks["fp32_flop_per_s"]), "ops": ops, "bytes": 0, "by": "operations",
           "texts": texts, "flop_per_text": per_text}
    ranker = work["predict"]
    work["ranker"] = ranker
    work["encoder"] = enc
    work["predict"] = {"seconds": enc["seconds"] + ranker["seconds"], "ops": enc["ops"] + ranker["ops"],
                       "bytes": ranker["bytes"], "by": "encoder operations, ranker " + ranker["by"]}
    return work
