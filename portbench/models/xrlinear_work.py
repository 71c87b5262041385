"""The operations and bytes that XR-Linear predict needs, counted from shapes
and from the reference's beam, never from the program's launches, so they
read the same whatever implements them.

Only real nonzeros count (a weight slot whose value is not 0; a query's own
nonzeros, not its padding).  For each batch:

- a level's work: its candidates are the children of the beam that enters
  it (the reference's beam); every distinct candidate row is read once per
  batch, 8 bytes a real slot (id and value); one multiply-add (2 operations)
  for each real slot of every candidate;
- a K1 call (one a level that the port scores with K1) reads those rows, one
  8-byte row index and writes one 4-byte score a candidate, and reads the
  batch's real query nonzeros at 8 bytes each;
- the whole predict (``mfu``) reads every level's rows, the queries once and
  writes the top-k once (a 4-byte label and a 4-byte score each); the
  candidate scores are intermediates that need not leave the chip.

Each bound is the larger of bytes over the peak bandwidth and operations
over the peak float32 rate, and says which one set it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import scipy.sparse as smat

# The port's layout rule as of this benchmark (``pecos_tpu_torch/xmc/
# inference.py``, DENSE_LAYOUT_MAX_ELEMENTS): a level whose dense (D+1, n)
# weights would hold more elements is stored packed and scored with K1.
K1_LAYOUT_MIN_ELEMENTS = (1 << 24) + 1


def k1_levels(D: int, sizes: Sequence[int]) -> List[bool]:
    """Whether each level is one the port scores with K1."""
    return [(D + 1) * n >= K1_LAYOUT_MIN_ELEMENTS for n in sizes]


def level_work(beam: np.ndarray, children: np.ndarray, real: np.ndarray) -> Dict[str, int]:
    """The work of one level for one batch: ``beam`` (N, B) the nodes
    entering it (-1 none), ``children`` the level's children table, ``real``
    the real slots of each of its nodes."""
    cand = np.where((beam >= 0)[..., None], children[np.clip(beam, 0, None)], -1).reshape(-1)
    cand = cand[cand >= 0]
    rows = np.unique(cand)
    return {
        "candidates": int(cand.size),
        "slots": int(real[cand].sum()),
        "rows": int(rows.size),
        "row_slots": int(real[rows].sum()),
    }


def leaf_spread(beam: np.ndarray, n_leaf: int) -> Dict[str, float]:
    """How widely a batch's beams spread: the distinct leaf clusters in
    ``beam`` (N, B), the nodes entering the label level (-1 none), beside
    the number that N beams of B clusters drawn uniformly would reach."""
    N, B = beam.shape
    return {"distinct": int(np.unique(beam[beam >= 0]).size),
            "uniform": float(n_leaf * (1.0 - (1.0 - B / n_leaf) ** N))}


def bound(n_bytes: float, n_ops: float, peaks: Dict) -> Dict[str, object]:
    t_bytes = n_bytes / float(peaks["hbm_bytes_per_s"])
    t_ops = n_ops / float(peaks["fp32_flop_per_s"])
    return {
        "seconds": max(t_bytes, t_ops),
        "by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": n_bytes,
        "ops": n_ops,
    }


def k1_call(lw: Dict[str, int], query_nnz: int, peaks: Dict) -> Dict[str, object]:
    n_bytes = 8 * lw["row_slots"] + 12 * lw["candidates"] + 8 * query_nnz
    return bound(n_bytes, 2 * lw["slots"], peaks)


def predict_batch(levels: Sequence[Dict[str, int]], query_nnz: int, n_queries: int, topk: int, peaks: Dict):
    n_bytes = sum(8 * lw["row_slots"] for lw in levels) + 8 * query_nnz + 8 * n_queries * topk
    return bound(n_bytes, sum(2 * lw["slots"] for lw in levels), peaks)


def traced_work(batches, children, real, k1_mask, topk: int, peaks: Dict) -> Dict[str, object]:
    """Sums over the traced batches.  ``batches``: (query nnz (N,), beams)
    with beams[d] (N, B_d) the reference's nodes entering level d."""
    k1 = {"seconds": 0.0, "bytes": 0, "ops": 0, "calls": 0, "by": set()}
    whole = {"seconds": 0.0, "bytes": 0, "ops": 0, "by": set()}
    levels = [{"candidates": 0, "rows": 0} for _ in children]
    spread = []
    for q_nnz, beams in batches:
        spread.append(leaf_spread(beams[-1], children[-1].shape[0]))
        qn = int(np.sum(q_nnz))
        lws = [level_work(b, c, r) for b, c, r in zip(beams, children, real)]
        for acc, lw in zip(levels, lws):
            acc["candidates"] += lw["candidates"]
            acc["rows"] += lw["rows"]
        for lw, is_k1 in zip(lws, k1_mask):
            if is_k1:
                one = k1_call(lw, qn, peaks)
                for key in ("seconds", "bytes", "ops"):
                    k1[key] += one[key]
                k1["calls"] += 1
                k1["by"].add(one["by"])
        one = predict_batch(lws, qn, len(q_nnz), topk, peaks)
        for key in ("seconds", "bytes", "ops"):
            whole[key] += one[key]
        whole["by"].add(one["by"])
    for acc in (k1, whole):
        acc["by"] = "+".join(sorted(acc["by"]))
    return {"k1": k1, "predict": whole, "batches": len(batches), "levels": levels, "leaf_spread": spread}


def traced(ref, model, traced_queries, cfg: Dict, peaks: Dict) -> Dict[str, object]:
    """The work of the traced batches (CSR, one a batch), from the
    reference's beams over them."""
    Q = smat.vstack(traced_queries, format="csr")
    beams = ref.beam_search(Q, keep_beams=True)["beams"]
    children = [ref.children[d].cpu().numpy() for d in range(ref.depth)]
    real = [(v != 0).sum(axis=1) for v in model.vals]
    batches, s = [], 0
    for q in traced_queries:
        n = q.shape[0]
        batches.append((np.diff(q.indptr), [b[s : s + n] for b in beams]))
        s += n
    return traced_work(batches, children, real, k1_levels(model.D, model.sizes), int(cfg["only_topk"]), peaks)
