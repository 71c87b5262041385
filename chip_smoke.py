"""Smoke run of the PyTorch + CUDA port (pecos_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                      # phases 1-11, the result lines last
    python3 chip_smoke.py --profile-ann        # phases 1-2, then torch.profiler over phase 11's dense build and sparse predict
    python3 chip_smoke.py --profile-predict    # phases 1-2, then torch.profiler over phase 6's batch loop and one predict

Phases, each printing a line; any failed check raises and the run exits
non-zero:

1. device  — needs torch.cuda; prints the card's name and power limit.
2. build   — compiles the CUDA kernels from pecos_tpu_torch/ops/csrc.
3. K1      — the intersection kernel against its plain PyTorch version on the
             card: over gathered blocks (intersect_scores) at the predict
             path's shape, at ragged, long-query and padded shapes, and at
             the sparse HNSW search and selection shapes (1<<30 pads on both
             sides); and by row id (intersect_scores_rows) as the callers
             call it: parent-layout rows with -1 rows at the predict and
             batch-1 shapes, a permutation of table rows at the HNSW
             gather-dots shape, lazy selection with empty slots, a query
             above one hash table's capacity, an odd P, and duplicate
             query ids.
4. timing  — K1 by row id at the four shapes of the main paths (predict,
             batch 1, HNSW gather-dots, lazy selection), the L2 flushed before
             each launch: kernel, plain version and a torch.searchsorted
             composite, beside the bound (bytes over 3.35 TB/s).
5. predict — XLinearModel.predict of 8,192 sparse queries through a random
             model of the Wiki-500K geometry (the repo's bench.py model:
             L=524,288, D=262,144, 64 weights per label, 16-way tree, beam 10,
             top 20), checked for shape, K1 launches and agreement with the
             same model on the CPU.
6. numbers — end-to-end QPS, compute ms per 1,024-query batch, peak memory.
7. wire    — the same predict on the float16, bfloat16 and uint8 query wires:
             K1 launches, agreement with the CPU on the same wire, top-20
             agreement with the float32 run, QPS of float32/float16/uint8 in turns.
8. realtime — a batch-1 RealtimeSession: 256 single-query calls against
             phase 5's rows, K1 launches per call, p50/p99 call latency and
             the on-device latency of one beam walk.
9. compiled — save_compiled_layers of the phase-5 model to a temporary
             directory; load_compiled_layers eager (labels of 1,024 queries
             equal phase 5's) and lazy with every layer streamed (agreement
             with eager; peak memory below the resident layers' bytes).
10. train  — (a) the Newton-CG solvers on the card against the port on the
             CPU (solve_block_coded, solve_cluster_bucket, solve_sparse_rows
             in both layouts) and host syncs per solve; (b) the golden fixture
             (tests/data) indexed and trained on the card, precision held to
             the golden run's, and once more with tfn+man negatives held to
             the same run on the CPU; (c) the repo's matched-recall training
             benchmark at full width (scripts/xmc_bench.py: 20,000 x 4,096
             train, 8,192 labels, 16-way tree, leaves of 100): PIFA and the
             clustering on the card, XLinearModel.train twice, then 4,000
             test queries predicted through K1 (beam 10, top 10), P@1 >= 0.80.
11. ann    — the repo's ANN geometries (benchmarks/README.md:42-133): (a)
             synthetic SIFT, 100,000 x 128, l2, M=32, efC=100, built on the
             card with the defaults (scan mode, bfloat16 search copy), exact
             top-10 by a float64 matmul, recall@10 >= 0.99 at efS=100 of
             10,000 queries, QPS at efS 50/100/200, 256 queries searched on
             the card and on the CPU over the graph (>= 99% equal ids), saved,
             loaded, searched again; (b) PQ4 (64 subspaces) grafted onto that
             graph, packed and unpacked ids equal on 1,000 queries, recall@10
             >= 0.95 at efS=200 (num_rerank 2 x efS); (c) the clustered sparse
             corpus (100,000 x 500,000 CSR, ip) built and searched through K1,
             tie-aware recall@10 >= 0.99 at efS=100; (d) PairwiseANN on (a)'s
             base with a random Y, the card against the CPU.

Every K1 launch of a phase's run is counted with the count set to 0 just
before it.  The line before the last is a JSON object describing each kernel
of the path; the last line is {"ok": true, "device": {...}}.
"""

import gc
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import scipy.sparse as smat

# the predict path's geometry (bench.py:34-70, 158-168)
L, D, NNZ_PER_LABEL, NR_SPLITS = 1 << 19, 1 << 18, 64, 16
N_QUERIES, Q_NNZ, BATCH, BEAM, TOPK = 8192, 256, 1024, 10, 20
N_CPU_CHECK = 64
SEED = 0

K1_SOURCE = "pecos_tpu_torch/ops/csrc/intersect.cu"
K1_REPLACES = "pecos_tpu/ops/intersect.py:86"


def unique_rows(rng, n_rows, width, hi):
    """(n_rows, width) int32, each row strictly increasing ids in [0, hi)."""
    base = np.sort(rng.integers(0, hi - width + 1, size=(n_rows, width), dtype=np.int64), axis=1)
    return (base + np.arange(width)).astype(np.int32)


def make_k1_case(N, K, P, Qn, D_feat, pad, seed):
    """K1 inputs (qids, qvals, w_packed) as numpy with frequent id matches;
    weight ids reach D_feat (the bias id); with ``pad`` some rows end in query
    pad ids D_feat+1 (value 0) and zero-valued weight pad slots (id 0), as the
    predict path pads them; with ``pad="hnsw"`` both sides end in SPARSE_PAD_ID
    (1<<30, value 0), as the HNSW graph's sparse rows are padded."""
    rng = np.random.default_rng(seed)
    qids = unique_rows(rng, N, Qn, D_feat)
    qvals = rng.standard_normal((N, Qn)).astype(np.float32)
    wi = unique_rows(rng, N * K, P, D_feat + 1).reshape(N, K, P)
    wv = rng.standard_normal((N, K, P)).astype(np.float32)
    if pad:
        qpad = np.arange(Qn)[None, :] >= (Qn - rng.integers(0, Qn // 2 + 1, size=N))[:, None]
        qids[qpad], qvals[qpad] = SPARSE_PAD_ID if pad == "hnsw" else D_feat + 1, 0.0
        wpad = np.arange(P)[None, None, :] >= (P - rng.integers(0, P // 2 + 1, size=(N, K)))[:, :, None]
        wi[wpad], wv[wpad] = SPARSE_PAD_ID if pad == "hnsw" else 0, 0.0
    return qids, qvals, np.concatenate([wi, wv.view(np.int32)], axis=-1)


# the sparse HNSW corpus's row cap (phase 11c: at most 68 nonzeros a row,
# rounded up to 32) and the HNSW pad id of both K1 operands
ANN_SPARSE_P = 96
SPARSE_PAD_ID = 1 << 30

# (name, N, K, P, Qn, pad, bias): the predict path's shape with and without the
# bias term, a ragged shape, a query longer than one shared-memory chunk (512),
# padded rows, the batch-1 realtime session's shape, and the sparse HNSW
# shapes: a search step's gathered neighbors (2,048 queries x 4 popped nodes x
# 64 neighbors) and one step of the lazy Alg-4 selection (candidate row against
# the M=32 selected rows)
K1_CASES = [
    ("main+bias", 1024, 160, 64, 256, False, True),
    ("main", 1024, 160, 64, 256, False, False),
    ("ragged", 3, 37, 8, 5, True, True),
    ("long-query", 8, 37, 64, 4096, True, True),
    ("padded", 64, 160, 64, 256, True, True),
    ("batch-1", 1, 160, 64, 256, False, True),
    ("hnsw gather-dots", 2048, 256, ANN_SPARSE_P, ANN_SPARSE_P, "hnsw", False),
    ("hnsw lazy-select", 2048, 32, ANN_SPARSE_P, ANN_SPARSE_P, "hnsw", False),
]
# K1 by row id: (name, N, K, P, Qn, layout, pad, bias, table rows), as the
# callers pass rows, then a query above one table's capacity (512), an odd P
# and duplicate query ids. layout "parents": the rows of 10 beam parents' 16
# children each in a parent_packed table of 4,096 parents, some -1; "perm":
# a random permutation of the table's rows; "select": the lazy selection's
# index into the HNSW corpus's rows, -1 past each row's count; "dups":
# random rows
K1_ROW_CASES = [
    ("predict by parent rows", 1024, 160, 64, 256, "parents", False, True, 4096 * NR_SPLITS),
    ("batch-1 by parent rows", 1, 160, 64, 256, "parents", False, True, 4096 * NR_SPLITS),
    ("hnsw gather-dots by id", 2048, 256, ANN_SPARSE_P, ANN_SPARSE_P, "perm", "hnsw", False, 2048 * 256),
    ("hnsw lazy-select by id", 2048, 32, ANN_SPARSE_P, ANN_SPARSE_P, "select", "hnsw", False, 100_000),
    ("above one table", 8, 37, 64, 5000, "perm", True, True, 8 * 37),
    ("odd P", 5, 7, 13, 600, "perm", True, True, 5 * 7),
    ("duplicate query ids", 64, 160, 64, 256, "dups", False, True, 20_000),
]
# the timed shapes: (name, N, K, P, Qn, layout, pad, bias, table rows): the
# last plabel layer's parent_packed (32,768 parents x 16 children), and the
# sparse HNSW corpus's 100,000 packed rows
K1_TIMED = [
    ("predict", 1024, 160, 64, 256, "parents", False, True, (L // NR_SPLITS) * NR_SPLITS),
    ("batch-1", 1, 160, 64, 256, "parents", False, True, (L // NR_SPLITS) * NR_SPLITS),
    ("hnsw gather-dots", 2048, 256, ANN_SPARSE_P, ANN_SPARSE_P, "perm", "hnsw", False, 100_000),
    ("hnsw lazy-select", 2048, 32, ANN_SPARSE_P, ANN_SPARSE_P, "select", "hnsw", False, 100_000),
]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet, at 700 W
FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores, the same sheet
L2_FLUSH_BYTES = 256 << 20  # written between timed launches: the 50 MB L2 starts cold
SLEEP_CYCLES = 1 << 27  # ~70 ms of the card's clock, while the host queues timed launches
WIRE_DTYPES = ("float16", "bfloat16", "uint8")
N_REALTIME, REALTIME_CAP = 256, 256
N_COMPILED = 1024

HERE = os.path.dirname(os.path.abspath(__file__))
# phase 10: a solve tight enough that W no longer depends on where a label's
# stopping test lands (ROADMAP F5), so the card and the CPU agree to rounding
TIGHT = dict(eps=1e-6, max_newton=60, cg_max=60)
SOLVER_ATOL = 1e-3
GOLDEN_ATOL = 0.02  # tests/test_golden.py's precision bar
# the matched-recall benchmark (scripts/xmc_bench.py:41-100, benchmarks/README.md:23-36)
MR_DATA = dict(n_trn=20000, n_tst=4000, d=4096, L=8192, seed=7)
MR_INDEX = dict(nr_splits=16, max_leaf_size=100)
MR_BEAM, MR_TOPK, MR_MIN_P1 = 10, 10, 0.80
# phase 11: the repo's two ANN geometries at their own sizes (benchmarks/README.md:42-133):
# synthetic SIFT, 128-d l2 (scripts/ann_bench_data.py:26 make_data), and the
# clustered TF-IDF-like corpus, 500,000-d CSR, ip (scripts/sparse_hnsw_bench.py:42 gen)
ANN_DENSE_DATA = dict(n=100_000, nq=10_000, seed=7)
ANN_SPARSE_DATA = dict(n=100_000, nq=2_000, d=500_000, seed=0)
ANN_BUILD = dict(M=32, efC=100)
ANN_TOPK = 10
ANN_DENSE_EFS, ANN_SPARSE_EFS, ANN_PQ_EFS = (50, 100, 200), (50, 100), (100, 200)
ANN_MIN_RECALL = 0.99  # recall@10 at efS=100, dense and sparse (tests/test_hnsw.py's bar)
ANN_PQ_MIN_RECALL = 0.95  # PQ4 recall@10 at efS=200, num_rerank 2 x efS
ANN_CPU_CHECK, ANN_PQ_CHECK, ANN_PQ_SUBSPACES = 256, 1000, 64
ANN_MIN_AGREE = 0.99  # (row, rank) ids equal, card against the CPU over one graph
ANN_PAIRS, ANN_LABELS = 4096, 1024  # PairwiseANN: (query, label) pairs; labels of a random Y


def check_k1(device, cases=K1_CASES):
    """Kernel vs plain version on ``device`` for every case; returns the max
    abs error.  Tolerance: rtol=1e-5 plus atol=1e-6 x max sum of |wv*qv|
    terms, since only the order of the final P-sum differs."""
    import torch

    from pecos_tpu_torch.ops.intersect import intersect_scores, intersect_scores_reference

    worst = 0.0
    for name, N, K, P, Qn, pad, bias in cases:
        D_feat = 4 * Qn  # small id range: many matches per candidate
        qids, qvals, w = make_k1_case(N, K, P, Qn, D_feat, pad, seed=N + K + P + Qn)
        bias_id, bias_val = (D_feat, 1.0) if bias else (None, 0.0)
        q, v, wp = (torch.from_numpy(a).to(device) for a in (qids, qvals, w))
        got = intersect_scores(q, v, wp, bias_id, bias_val)
        want = intersect_scores_reference(q, v, wp, bias_id, bias_val)
        w_abs = torch.cat([wp[..., :P], wp[..., P:].view(torch.float32).abs().view(torch.int32)], dim=-1)
        scale = intersect_scores_reference(q, v.abs(), w_abs, bias_id, abs(bias_val)).max().item()
        if device.type == "cuda":
            torch.cuda.synchronize()
        err = (got - want).abs()
        tol = 1e-5 * want.abs() + 1e-6 * scale
        bad = int((err > tol).sum())
        max_err = err.max().item()
        print(f"K1 {name} N={N} K={K} P={P} Qn={Qn}: max_abs_err={max_err!r} scale={scale!r} bad={bad}")
        if bad or not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"K1 {name}: {bad} entries outside tolerance (max abs err {max_err!r})")
        worst = max(worst, max_err)
    return worst


def make_rows_case(device, N, K, P, Qn, layout, pad, bias, R, seed):
    """K1 by-id inputs on ``device``: (qids, qvals, table (R, 2P), rows (N, K)
    int64).  Queries as make_k1_case's; the table's rows hold random ids in
    [0, 4*Qn] (the bias id 4*Qn among them), values from a normal, and with
    ``pad`` a zero-valued tail (id 0, or SPARSE_PAD_ID with pad="hnsw");
    ``layout`` sets the index as K1_ROW_CASES says."""
    import torch

    D_feat = 4 * Qn
    qids, qvals, _ = make_k1_case(N, 1, 8, Qn, D_feat, pad, seed)
    if layout == "dups":  # every other nonzero repeats its neighbour's id, with its own value
        qids[:, 1::2] = qids[:, 0::2]
    gen = torch.Generator(device).manual_seed(seed)
    ids = torch.randint(0, D_feat + 1, (R, P), generator=gen, device=device, dtype=torch.int32)
    vals = torch.randn((R, P), generator=gen, device=device)
    if pad:
        tail = torch.randint(0, P // 2 + 1, (R, 1), generator=gen, device=device)
        empty = torch.arange(P, device=device)[None, :] >= P - tail
        ids[empty], vals[empty] = SPARSE_PAD_ID if pad == "hnsw" else 0, 0.0
    if layout == "parents":  # missing children: zero rows of parent_packed
        gone = torch.rand((R,), generator=gen, device=device) < 0.05
        ids[gone], vals[gone] = 0, 0.0
    table = torch.cat([ids, vals.view(torch.int32)], dim=1)
    if layout == "parents":
        parents = torch.randint(0, R // NR_SPLITS, (N, K // NR_SPLITS), generator=gen, device=device)
        rows = (parents[:, :, None] * NR_SPLITS + torch.arange(NR_SPLITS, device=device)).reshape(N, K)
        rows[torch.rand((N, K), generator=gen, device=device) < 0.02] = -1
    elif layout == "perm":
        perm = torch.randperm(R, generator=gen, device=device)
        rows = perm[torch.arange(N * K, device=device) % R].reshape(N, K)
    else:
        rows = torch.randint(0, R, (N, K), generator=gen, device=device)
        if layout == "select":  # slots past each row's count are empty
            count = torch.randint(0, K + 1, (N, 1), generator=gen, device=device)
            rows[torch.arange(K, device=device)[None, :] >= count] = -1
    q, v = torch.from_numpy(qids).to(device), torch.from_numpy(qvals).to(device)
    return q, v, table, rows, ((D_feat, 1.0) if bias else ())


def check_k1_rows(device, cases=K1_ROW_CASES):
    """intersect_scores_rows vs its plain version on ``device`` for every
    by-id case; returns the max abs error.  Tolerance as check_k1's (the order
    of the final P-sum and of duplicate ids' sum differ)."""
    import torch

    from pecos_tpu_torch.ops.intersect import intersect_scores_rows, intersect_scores_rows_reference

    worst = 0.0
    for name, N, K, P, Qn, layout, pad, bias, R in cases:
        q, v, table, rows, bias_args = make_rows_case(device, N, K, P, Qn, layout, pad, bias, R, seed=N + K + Qn)
        got = intersect_scores_rows(q, v, table, rows, *bias_args)
        want = intersect_scores_rows_reference(q, v, table, rows, *bias_args)
        t_abs = torch.cat([table[:, :P], table[:, P:].view(torch.float32).abs().view(torch.int32)], dim=1)
        scale = intersect_scores_rows_reference(q, v.abs(), t_abs, rows, *bias_args).max().item()
        if device.type == "cuda":
            torch.cuda.synchronize()
        err = (got - want).abs()
        bad = int((err > 1e-5 * want.abs() + 1e-6 * scale).sum())
        max_err = err.max().item()
        empty = int((rows < 0).sum())
        print(f"K1 {name} N={N} K={K} P={P} Qn={Qn} table {tuple(table.shape)}, {empty} rows -1: "
              f"max_abs_err={max_err!r} scale={scale!r} bad={bad}")
        if bad or not bool(torch.isfinite(got).all()) or bool((got[rows < 0] != 0).any()):
            raise RuntimeError(f"K1 {name}: {bad} entries outside tolerance (max abs err {max_err!r}) or a -1 row not 0")
        worst = max(worst, max_err)
    return worst


def k1_composite(qids, qvals, table, rows, bias_id=None, bias_val=0.0):
    """K1's function from torch operations: sorted query ids, the weight
    ids' positions among them (torch.searchsorted), gather, compare,
    multiply, sum.  A yardstick the port never calls: it takes the first of
    repeated query ids only, so it agrees with K1 where the nonzero ids are
    unique (and every pad's value is 0)."""
    import torch

    from pecos_tpu_torch.ops.intersect import split_packed

    qs, order = torch.sort(qids, dim=1)
    vs = qvals.gather(1, order)
    w = torch.where((rows >= 0)[..., None], table[rows.clamp(min=0)], 0)
    wi, wv = split_packed(w)
    N, K, P = wi.shape
    flat = wi.reshape(N, K * P)
    pos = torch.searchsorted(qs, flat).clamp(max=qs.shape[1] - 1)
    g = torch.where(qs.gather(1, pos) == flat, vs.gather(1, pos), 0.0).reshape(N, K, P)
    out = (g * wv).sum(dim=-1)
    if bias_id is not None:
        out = out + bias_val * torch.where(wi == bias_id, wv, 0.0).sum(dim=-1)
    return out


def k1_bound(q, table, rows, P):
    """(bound ms, "bytes" or "operations", bytes) of one K1 call on these
    inputs: the table rows it must read (each distinct row once), the index,
    the queries and the output, over the HBM rate; its multiply-adds (rows
    that are not -1) over the float32 rate."""
    used = rows[rows >= 0]
    n_bytes = int(used.unique().numel()) * 2 * P * 4 + rows.numel() * 8 + 2 * q.numel() * 4 + rows.numel() * 4
    ops = 2 * int(used.numel()) * P
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), n_bytes


def time_k1(device, name, N, K, P, Qn, layout, pad, bias, R, iters):
    """K1 by row id at one of the K1_TIMED shapes: median ms of the kernel,
    the plain version and the searchsorted composite, in turns, each launch
    timed with CUDA events after a write of L2_FLUSH_BYTES, all queued behind
    a sleep of the card; with the bound."""
    import torch

    from pecos_tpu_torch.ops.intersect import intersect_scores_rows, intersect_scores_rows_reference

    q, v, table, rows, bias_args = make_rows_case(device, N, K, P, Qn, layout, pad, bias, R, seed=1)
    fns = {
        "kernel": lambda: intersect_scores_rows(q, v, table, rows, *bias_args),
        "plain": lambda: intersect_scores_rows_reference(q, v, table, rows, *bias_args),
        "composite": lambda: k1_composite(q, v, table, rows, *bias_args),
    }
    outs = {key: fn() for key, fn in fns.items()}  # warm
    err = (outs["composite"] - outs["plain"]).abs().max().item()
    if not err <= 1e-4 * max(outs["plain"].abs().max().item(), 1.0):
        raise RuntimeError(f"K1 timing {name}: the composite differs from the plain version by {err!r}")
    del outs
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=device)
    events = {key: [] for key in fns}
    # the card sleeps while the host queues every launch, so no event
    # interval holds host time (each wrapper's Python and ctypes overhead)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    for i in range(iters):
        for key in (list(fns) if i % 2 == 0 else list(fns)[::-1]):
            flush.fill_(float(i))
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fns[key]()
            end.record()
            events[key].append((start, end))
    torch.cuda.synchronize()
    times = {key: [s.elapsed_time(e) for s, e in ev] for key, ev in events.items()}
    bound_ms, bound_by, n_bytes = k1_bound(q, table, rows, P)
    ms = {key: statistics.median(t) for key, t in times.items()}
    return {
        "N": N, "K": K, "P": P, "Qn": Qn, "table_rows": R, "ms": ms["kernel"], "plain_ms": ms["plain"],
        "composite_ms": ms["composite"], "bound_ms": bound_ms, "bound_by": bound_by, "bytes": n_bytes,
        "share": bound_ms / ms["kernel"],
    }


def build_chain(L_=L, D_=D, nnz=NNZ_PER_LABEL, nr_splits=NR_SPLITS, seed=SEED):
    """(Ws, Cs) of a random tree model: levels nr_splits, nr_splits^2, ... L_.
    Levels whose dense W fits 2^24 elements get dense weights (bench.py's
    layer 0); the others nnz weights per label: nnz-1 on distinct features plus
    the bias feature, as a trained model's labels carry a bias weight."""
    rng = np.random.default_rng(seed)
    sizes = [L_]
    while sizes[0] > nr_splits:
        sizes.insert(0, sizes[0] // nr_splits)
    Ws, Cs, n_parents = [], [], 1
    for n in sizes:
        if n * (D_ + 1) <= (1 << 24):
            W = smat.csc_matrix((rng.standard_normal((D_ + 1, n)) * 0.05).astype(np.float32))
        else:
            rows = np.concatenate([unique_rows(rng, n, nnz - 1, D_), np.full((n, 1), D_, np.int32)], axis=1)
            vals = (rng.standard_normal((n, nnz)) * 0.05).astype(np.float32)
            indptr = np.arange(0, n * nnz + 1, nnz, dtype=np.int64)
            W = smat.csc_matrix((vals.ravel(), rows.ravel(), indptr), shape=(D_ + 1, n))
        parent = np.arange(n, dtype=np.int64) * n_parents // n
        Cs.append(smat.csc_matrix((np.ones(n, np.float32), (np.arange(n), parent)), shape=(n, n_parents)))
        Ws.append(W)
        n_parents = n
    return Ws, Cs


def make_queries(n=N_QUERIES, D_=D, nnz=Q_NNZ, seed=SEED + 1):
    """CSR (n, D_) queries with nnz distinct sorted features each (bench.py's values)."""
    rng = np.random.default_rng(seed)
    ids = unique_rows(rng, n, nnz, D_)
    vals = (rng.standard_normal((n, nnz)) * 0.1).astype(np.float32)
    return smat.csr_matrix((vals.ravel(), ids.ravel(), np.arange(0, n * nnz + 1, nnz)), shape=(n, D_))


def xlinear(Ws, Cs, device):
    from pecos_tpu_torch.xmc import HierarchicalMLModel, MLModel
    from pecos_tpu_torch.xmc.xlinear import XLinearModel

    return XLinearModel(HierarchicalMLModel([MLModel(W, C, bias=1.0, device=device) for W, C in zip(Ws, Cs)]))


def ranked(P, k):
    """(labels, scores) as (n, k) arrays in rank order, from a top-k CSR."""
    if not (np.diff(P.indptr) == k).all():
        raise RuntimeError("a prediction row does not hold exactly top-k entries")
    return P.indices.reshape(-1, k), P.data.reshape(-1, k)


def check_predict(P, P_cpu, n_labels, n_queries, n_plabel, batch, launches, what="predict"):
    """Shape, launch count and CPU agreement checks of a full-width predict
    run; returns the label agreement share."""
    if P.shape != (n_queries, n_labels):
        raise RuntimeError(f"prediction shape {P.shape} != {(n_queries, n_labels)}")
    labels, scores = ranked(P, TOPK)
    if labels.min() < 0 or labels.max() >= n_labels or not np.isfinite(scores).all():
        raise RuntimeError("labels out of range or scores not finite")
    want_launches = n_plabel * -(-n_queries // batch)
    if launches != want_launches:
        raise RuntimeError(f"{what}: K1 launched {launches} times, expected {want_launches}")
    c_labels, c_scores = ranked(P_cpu, TOPK)
    n_cpu = c_labels.shape[0]
    return check_agreement(labels[:n_cpu], scores[:n_cpu], c_labels, c_scores, f"{what}: label agreement with the CPU run on {n_cpu} queries")


def check_agreement(labels, scores, want_labels, want_scores, what):
    """Share of equal (row, rank) labels, which must be >= 0.995, and scores
    of the equal ones within rtol=1e-4 (float32 sums in another order)."""
    same = labels == want_labels
    agree = float(same.mean())
    print(f"{what}: {agree!r}")
    if agree < 0.995:
        raise RuntimeError(f"{what}: {agree!r} < 0.995")
    if not np.allclose(scores[same], want_scores[same], rtol=1e-4, atol=0.0):
        raise RuntimeError(f"{what}: scores of agreeing labels differ beyond rtol=1e-4")
    return agree


def topk_overlap(P, Q, k=TOPK):
    """Mean share of each row's top-k labels in Q that P's top-k also holds."""
    a, b = np.sort(ranked(P, k)[0], axis=1), np.sort(ranked(Q, k)[0], axis=1)
    hits = sum(int(np.isin(x, y, assume_unique=True).sum()) for x, y in zip(a, b))
    return hits / a.size


def run_wire(xlm, xlm_cpu, X, P32, n_plabel, smi, kw):
    """Phase 7: predict on each compressed wire; returns (K1 launches by wire,
    QPS of float32/float16/uint8 measured in turns)."""
    from pecos_tpu_torch.ops.intersect import intersect_scores

    launches = {}
    for dt in WIRE_DTYPES:
        intersect_scores.launches = 0
        P = xlm.predict(X, wire_value_dtype=dt, **kw)
        launches[dt] = intersect_scores.launches
        P_cpu = xlm_cpu.predict(X[:N_CPU_CHECK], wire_value_dtype=dt, **kw)
        check_predict(P, P_cpu, L, N_QUERIES, n_plabel, BATCH, launches[dt], what=f"wire {dt}")
        print(f"wire {dt} [{smi}]: K1 launches {launches[dt]}, top-{TOPK} agreement with the float32 run "
              f"{topk_overlap(P, P32)!r}")
    best = {dt: float("inf") for dt in ("float32", "float16", "uint8")}
    for rep in range(3):
        for dt in (list(best) if rep % 2 == 0 else list(best)[::-1]):
            t0 = time.perf_counter()
            xlm.predict(X, wire_value_dtype=dt, **kw)
            best[dt] = min(best[dt], time.perf_counter() - t0)
    qps = {dt: N_QUERIES / t for dt, t in best.items()}
    for dt, q in qps.items():
        print(f"wire {dt} [{smi}]: end-to-end {q!r} QPS (best of 3 in turns, {best[dt]!r} s for {N_QUERIES} queries)")
    return launches, qps


def run_realtime(xlm, X, P5, n_plabel, smi, kw):
    """Phase 8: a batch-1 session; returns (K1 launches, latency numbers)."""
    from pecos_tpu_torch.ops.intersect import intersect_scores

    sess = xlm.realtime_session(batch=1, cap=REALTIME_CAP, **kw)
    lat_ms, rows = [], []
    intersect_scores.launches = 0
    for i in range(N_REALTIME):
        t0 = time.perf_counter()
        Pi = sess.predict(X[i])
        lat_ms.append((time.perf_counter() - t0) * 1000.0)
        rows.append(ranked(Pi, TOPK))
    launches = intersect_scores.launches
    if launches != n_plabel * N_REALTIME:
        raise RuntimeError(f"realtime: K1 launched {launches} times in {N_REALTIME} calls, expected {n_plabel} a call")
    labels, scores = np.vstack([r[0] for r in rows]), np.vstack([r[1] for r in rows])
    want_labels, want_scores = ranked(P5[:N_REALTIME], TOPK)
    print(f"realtime: rows equal to phase 5's: {int((labels == want_labels).all(axis=1).sum())} of {N_REALTIME}")
    check_agreement(labels, scores, want_labels, want_scores, "realtime: label agreement with phase 5")
    p50, p99 = (float(v) for v in np.percentile(lat_ms, [50, 99]))
    on_device = sess.on_device_latency_ms(X[:1], iters=32)
    print(f"realtime [{smi}]: batch-1 call latency p50 {p50!r} ms, p99 {p99!r} ms ({N_REALTIME} calls); "
          f"on-device {on_device!r} ms per beam walk (32 chained walks, CUDA events); "
          f"K1 launches per call {launches // N_REALTIME}")
    return launches, {"p50_ms": p50, "p99_ms": p99, "on_device_ms": on_device}


def run_compiled(compiled, X, P5, n_plabel, smi, kw, device):
    """Phase 9: compiled folder saved, loaded eager and lazy; returns K1
    launches of the eager and the lazy predict."""
    import torch

    from pecos_tpu_torch.ops.intersect import intersect_scores
    from pecos_tpu_torch.xmc.inference import build_parent_packed, load_compiled_layers, save_compiled_layers

    Xq = X[:N_COMPILED]
    want_labels, want_scores = ranked(P5[:N_COMPILED], TOPK)
    layer_bytes = sum(l.nbytes for l in compiled.layers)
    with tempfile.TemporaryDirectory(prefix="pecos_compiled_") as folder:
        t0 = time.perf_counter()
        save_compiled_layers(compiled.layers, compiled.bias, compiled.nr_features, folder)
        save_s = time.perf_counter() - t0
        file_bytes = sum(os.path.getsize(os.path.join(folder, f)) for f in os.listdir(folder))
        t0 = time.perf_counter()
        eager = load_compiled_layers(folder, device=device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        intersect_scores.launches = 0
        P_eager = eager.predict(Xq, **kw)
        eager_launches = intersect_scores.launches
        if eager_launches != n_plabel:
            raise RuntimeError(f"compiled eager: K1 launched {eager_launches} times, expected {n_plabel}")
        e_labels, e_scores = ranked(P_eager, TOPK)
        if not np.array_equal(e_labels, want_labels):
            raise RuntimeError(f"compiled eager: {int((e_labels != want_labels).sum())} labels differ from phase 5")
        del eager, P_eager
        gc.collect()
        with np.load(os.path.join(folder, f"layer_{compiled.depth - 1}.npz")) as z:
            packed, children = z["packed"], z["children"]
        t0 = time.perf_counter()
        build_parent_packed(packed, children)
        pp_s = time.perf_counter() - t0
        del packed, children
        t0 = time.perf_counter()
        lazy = load_compiled_layers(folder, lazy=True, resident_budget_bytes=0, device=device)
        lazy_load_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        intersect_scores.launches = 0
        t0 = time.perf_counter()
        P_lazy = lazy.predict(Xq, **kw)
        lazy_s = time.perf_counter() - t0
        lazy_launches = intersect_scores.launches
        lazy_peak = torch.cuda.max_memory_allocated() - base
    check_agreement(*ranked(P_lazy, TOPK), e_labels, e_scores, f"compiled lazy: label agreement with eager on {N_COMPILED} queries")
    x_bytes = N_COMPILED * (D + 1) * 4
    print(f"compiled [{smi}]: save {save_s!r} s ({file_bytes} bytes on disk), eager load {load_s!r} s, "
          f"lazy open {lazy_load_s!r} s, parent_packed rebuild of the last layer {pp_s!r} s (host)")
    print(f"compiled [{smi}]: lazy predict of {N_COMPILED} queries {lazy_s!r} s, every layer streamed; peak device "
          f"memory above the start {lazy_peak} bytes = query block {x_bytes} + {lazy_peak - x_bytes} "
          f"(resident layers of the eager model: {layer_bytes} bytes); K1 launches eager {eager_launches}, lazy {lazy_launches}")
    if lazy_peak - x_bytes >= layer_bytes:
        raise RuntimeError(f"compiled lazy: peak minus the query block {lazy_peak - x_bytes} >= resident layers {layer_bytes}")
    return eager_launches, lazy_launches


class SolveCounter:
    """Counts the Newton-CG solves and the host syncs they make while active."""

    def __enter__(self):
        from pecos_tpu_torch.xmc import solvers

        self._solvers, self._core = solvers, solvers._newton_cg
        self.solves, self._syncs0 = 0, solvers.all_converged.syncs

        def counted(*args, **kwargs):
            self.solves += 1
            return self._core(*args, **kwargs)

        solvers._newton_cg = counted
        return self

    def __exit__(self, *exc):
        self._solvers._newton_cg = self._core
        self.syncs = self._solvers.all_converged.syncs - self._syncs0

    def per_solve(self):
        return self.syncs / max(self.solves, 1)


def solver_cases(rng):
    """(name, solver, args as numpy, kwargs) of phase 10a: small problems with
    more rows than features or a cost that keeps them well conditioned."""
    N, D, Lb = 2048, 257, 64
    X = rng.standard_normal((N, D)).astype(np.float32)
    X[:, -1] = 1.0
    codes = rng.choice(np.array([0, 1, 2], np.uint8), size=(N, Lb), p=[0.2, 0.2, 0.6])
    R = rng.uniform(0.5, 2.0, size=(N, Lb)).astype(np.float32)
    Cb, P, xcap, F2, ns = 8, 128, 16, 256, 16
    ids = np.argsort(rng.uniform(size=(Cb, P, F2)), axis=2)[:, :, :xcap].astype(np.int32)
    vals = rng.standard_normal((Cb, P, xcap)).astype(np.float32)
    y = np.where(rng.uniform(size=(Cb, P, ns)) < 0.3, 1.0, -1.0).astype(np.float32)
    c = rng.uniform(0.5, 1.5, size=(Cb, P, ns)).astype(np.float32)
    Pr, xr, Db = 1024, 32, 2000
    r_ids = np.argsort(rng.uniform(size=(Pr, Db)), axis=1)[:, :xr].astype(np.int32)
    r_ids[::3, -4:] = Db  # padded slots
    r_vals = np.where(r_ids < Db, rng.standard_normal((Pr, xr)), 0.0).astype(np.float32)
    r_y = np.where(rng.uniform(size=(Pr, ns)) < 0.3, 1.0, -1.0).astype(np.float32)
    r_c = rng.uniform(0.5, 1.5, size=(Pr, ns)).astype(np.float32)
    return [
        ("solve_block_coded", "solve_block_coded", (X, codes, 1.0, 1.0, R), {}),
        ("solve_cluster_bucket", "solve_cluster_bucket", (ids, vals, y, c), dict(F2=F2)),
        ("solve_sparse_rows dense", "solve_sparse_rows", (r_ids, r_vals, r_y, r_c), dict(Db=Db)),
        ("solve_sparse_rows chunked", "solve_sparse_rows", (r_ids, r_vals, r_y, r_c), dict(Db=Db)),
    ]


def check_solvers(device, smi):
    """Phase 10a: each solver on the card against the port on the CPU, same
    inputs, tight solve; W within atol SOLVER_ATOL.  Returns the max abs error."""
    import torch

    from pecos_tpu_torch.xmc import solvers

    worst = 0.0
    for name, fn, args, kw in solver_cases(np.random.default_rng(SEED + 10)):
        out = []  # W on the CPU, then on the card
        for dev in (torch.device("cpu"), device):
            targs = [torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a for a in args]
            budget = solvers._GLOBAL_DENSE_BUDGET
            if name.endswith("chunked"):
                solvers._GLOBAL_DENSE_BUDGET = 0
            try:
                with SolveCounter() as count:
                    t0 = time.perf_counter()
                    W = getattr(solvers, fn)(*targs, **kw, **TIGHT)
                    out.append(W.cpu().numpy())
                    secs = time.perf_counter() - t0
            finally:
                solvers._GLOBAL_DENSE_BUDGET = budget
        want, got = out
        err = float(np.abs(got - want).max())
        print(f"train solvers {name} W {got.shape}: max_abs_err vs CPU {err!r} (|W| max "
              f"{float(np.abs(want).max())!r}); on the card {secs!r} s, {count.syncs} host syncs in "
              f"{count.solves} solve [{smi}]")
        if not (err <= SOLVER_ATOL and np.isfinite(got).all()):
            raise RuntimeError(f"train solvers {name}: W differs from the CPU's by {err!r} > {SOLVER_ATOL}")
        worst = max(worst, err)
    return worst


def run_golden(device, smi):
    """Phase 10b: the golden fixture indexed and trained on the card; returns
    K1 launches of the train and predict."""
    from pecos_tpu_torch.ops.intersect import intersect_scores
    from pecos_tpu_torch.utils import smat_util
    from pecos_tpu_torch.xmc import Indexer, LabelEmbeddingFactory
    from pecos_tpu_torch.xmc.xlinear import XLinearModel

    data = os.path.join(HERE, "tests", "data")
    X, Y, Xt, Yt = (smat_util.load_matrix(os.path.join(data, f)).tocsr() for f in ("X.trn.npz", "Y.trn.npz", "X.tst.npz", "Y.tst.npz"))
    golden_prec = np.load(os.path.join(data, "golden_prec.npy"))
    chain = Indexer.gen(LabelEmbeddingFactory.create(Y, X, method="pifa"), max_leaf_size=4, nr_splits=2, seed=11, device=device)
    intersect_scores.launches = 0
    model = XLinearModel.train(X, Y, C=chain, threshold=0.0, device=device)
    prec = smat_util.Metrics.generate(Yt, model.predict(Xt, beam_size=8, only_topk=5), topk=5).prec
    launches = intersect_scores.launches
    print(f"train golden: chain {[C.shape for C in chain]}, P@1..5 {prec.tolist()} vs golden {golden_prec.tolist()}, "
          f"K1 launches {launches} (every layer of this model is dense)")
    if not np.allclose(prec, golden_prec, atol=GOLDEN_ATOL, rtol=0):
        raise RuntimeError(f"train golden: precision {prec} not within {GOLDEN_ATOL} of the golden {golden_prec}")
    precs = {}
    for dev in (device, "cpu"):
        m = XLinearModel.train(X, Y, C=chain, threshold=0.0, negative_sampling_scheme="tfn+man", device=dev)
        precs[str(dev)] = smat_util.Metrics.generate(Yt, m.predict(Xt, beam_size=8, only_topk=5), topk=5).prec
    p_card, p_cpu = precs[str(device)], precs["cpu"]
    print(f"train golden tfn+man: P@1..5 on the card {p_card.tolist()}, on the CPU {p_cpu.tolist()}")
    if not np.allclose(p_card, p_cpu, atol=GOLDEN_ATOL, rtol=0):
        raise RuntimeError(f"train golden tfn+man: card {p_card} vs CPU {p_cpu} beyond {GOLDEN_ATOL}")
    return launches


def load_script(name):
    """scripts/<name>.py as a module (xmc_bench, ann_bench_data and
    sparse_hnsw_bench import numpy and scipy only at their top level)."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_matched_recall(device, smi):
    """Phase 10c: index, train twice, predict through K1; returns (K1
    launches of the predict, numbers)."""
    import torch

    from pecos_tpu_torch.ops.intersect import intersect_scores
    from pecos_tpu_torch.utils import smat_util
    from pecos_tpu_torch.xmc import Indexer, LabelEmbeddingFactory
    from pecos_tpu_torch.xmc.xlinear import XLinearModel

    t0 = time.perf_counter()
    X, Y, Xt, Yt = load_script("xmc_bench").make_data(**MR_DATA)
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    chain = Indexer.gen(LabelEmbeddingFactory.create(Y, X, method="pifa"), device=device, **MR_INDEX)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    train_s, peaks = [], []
    for _ in range(2):
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with SolveCounter() as count:
            t0 = time.perf_counter()
            model = XLinearModel.train(X, Y, C=chain, shallow=True, device=device)
            torch.cuda.synchronize()
            train_s.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated() - base)
    layers = [(m.nr_labels, m.nr_codes, m.W.nnz) for m in model.model.model_chain]
    kw = dict(beam_size=MR_BEAM, only_topk=MR_TOPK)
    intersect_scores.launches = 0
    P = model.predict(Xt, **kw)
    launches = intersect_scores.launches
    if P.shape != Yt.shape or not np.isfinite(P.data).all() or (np.diff(P.indptr) != MR_TOPK).any():
        raise RuntimeError(f"train predict: {P.shape} with {P.nnz} entries, not {MR_TOPK} finite labels for each of {Yt.shape[0]}")
    m = smat_util.Metrics.generate(Yt, P, topk=MR_TOPK)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        model.predict(Xt, **kw)
        best = min(best, time.perf_counter() - t0)
    qps = Xt.shape[0] / best
    kinds = [l.kind for l in model.model._get_compiled().layers]
    print(f"train matched-recall: data {X.shape} x {Y.shape[1]} labels made in {data_s!r} s; index (PIFA + clustering "
          f"on the card) {index_s!r} s, chain {[C.shape for C in chain]} [{smi}]")
    print(f"train matched-recall [{smi}]: XLinearModel.train first {train_s[0]!r} s, second {train_s[1]!r} s; peak "
          f"device memory above the start {peaks[0]} / {peaks[1]} bytes; {count.solves} solves, {count.syncs} host "
          f"syncs ({count.per_solve()!r} per solve); layers (labels, codes, nnz W) {layers}")
    print(f"train matched-recall predict [{smi}]: {Xt.shape[0]} queries, beam {MR_BEAM}, top {MR_TOPK}, layers {kinds}: "
          f"P@1/3/5 {m.prec[0]!r} / {m.prec[2]!r} / {m.prec[4]!r}, recall@10 {m.recall[9]!r}; "
          f"{qps!r} QPS (best of 3); K1 launches {launches}")
    if launches <= 0:
        raise RuntimeError("train predict: K1 was not launched")
    if m.prec[0] < MR_MIN_P1:
        raise RuntimeError(f"train predict: P@1 {m.prec[0]!r} < {MR_MIN_P1}")
    return launches, {
        "index_s": index_s, "train_s": train_s, "peak_bytes": peaks, "syncs_per_solve": count.per_solve(),
        "prec": m.prec.tolist(), "recall10": float(m.recall[9]), "qps": qps,
    }


def recall_at(ids, true_ids):
    """Recall@k: the mean share of each row's true top-k ids that its returned row holds."""
    return sum(int(np.isin(p, t).sum()) for p, t in zip(ids, true_ids)) / true_ids.size


def exact_topk_l2(base, queries, k, device, chunk=2048):
    """Exact l2 top-k ids, a plain float64 matmul on the card (the harness's own, not the port's)."""
    import torch

    X = torch.from_numpy(base).to(device, torch.float64)
    xx = (X * X).sum(1)
    out = []
    for s in range(0, len(queries), chunk):
        Q = torch.from_numpy(queries[s : s + chunk]).to(device, torch.float64)
        d = (Q * Q).sum(1, keepdim=True) + xx[None, :] - 2.0 * (Q @ X.T)
        out.append(torch.topk(d, k, dim=1, largest=False).indices.cpu().numpy())
    return np.vstack(out)


def sparse_tie_recall(ids, X, Q, gt_d):
    """Tie-aware recall@k of ip search, the rule of scripts/sparse_hnsw_bench.py:160
    tie_recall (a returned row counts when its exact distance is within the k-th
    true distance, x(1 + 1e-4) + 1e-6), with each returned row's similarity
    taken from X in float64."""
    k = gt_d.shape[1]
    thr = gt_d[:, k - 1] * (1 + 1e-4) + 1e-6
    rows = np.clip(ids, 0, X.shape[0] - 1).ravel()
    qrow = np.repeat(np.arange(Q.shape[0]), ids.shape[1])
    sims = np.asarray(X[rows].astype(np.float64).multiply(Q[qrow].astype(np.float64)).sum(axis=1)).reshape(ids.shape)
    d = np.where(ids >= 0, 1.0 - sims, np.inf)
    return float((d <= thr[:, None]).mean())


def best_time(fn, reps=2):
    """(result of the last call, best seconds of ``reps`` calls); fn ends in a fetch."""
    best, out = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return out, best


def check_ann_agreement(ids, want_ids, what, dists=None, want_dists=None, atol=1e-4):
    """Share of equal (row, rank) ids, which must be >= ANN_MIN_AGREE; the
    distances of the equal ones within rtol=1e-4 and ``atol`` (float32 sums
    in another order; an l2 distance |q|^2 + |x|^2 - 2<q, x> carries the
    rounding of its largest term, so its callers pass 1e-6 x that term)."""
    same = ids == want_ids
    agree = float(same.mean())
    print(f"{what}: {agree!r}")
    if agree < ANN_MIN_AGREE:
        raise RuntimeError(f"{what}: {agree!r} < {ANN_MIN_AGREE}")
    if dists is not None:
        err = np.abs(dists[same] - want_dists[same]) - 1e-4 * np.abs(want_dists[same])
        if (err > atol).any():
            raise RuntimeError(f"{what}: distances of agreeing ids differ by {float(err.max())!r} beyond rtol=1e-4, atol={atol!r}")
    return agree


def run_ann_dense(device, smi):
    """Phase 11a: synthetic SIFT at 100K, built and searched on the card;
    returns (model, base, queries, true top-10, numbers)."""
    import torch

    from pecos_tpu_torch.ann import HNSW
    from pecos_tpu_torch.ann.hnsw.graph import read_flag

    t0 = time.perf_counter()
    base, queries = load_script("ann_bench_data").make_data(**ANN_DENSE_DATA)
    true_ids = exact_topk_l2(base, queries, ANN_TOPK, device)
    data_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reads0 = read_flag.syncs
    t0 = time.perf_counter()
    model = HNSW.train(base, metric_type="l2", device=device, **ANN_BUILD)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - mem0
    build_reads = read_flag.syncs - reads0
    levels = np.bincount(model.node_levels).tolist()
    print(f"ann dense: data {base.shape} + {queries.shape[0]} queries and exact top-{ANN_TOPK} on the card in {data_s!r} s")
    print(f"ann dense build [{smi}]: l2, M={ANN_BUILD['M']} efC={ANN_BUILD['efC']}, defaults (scan mode, intra_k 32, "
          f"bfloat16 search copy): {build_s!r} s, peak device memory above the start {peak} bytes, "
          f"{build_reads} host reads of loop flags; points per level {levels}")
    numbers = {"build_s": build_s, "peak_bytes": peak, "build_reads": build_reads}
    chunks = -(-queries.shape[0] // model.pred_params.batch_size)
    for efS in ANN_DENSE_EFS:
        reads0 = read_flag.syncs
        (ids, dists), secs = best_time(lambda: model.predict(queries, efS=efS, topk=ANN_TOPK))
        reads = (read_flag.syncs - reads0) / 2 / chunks
        if ids.shape != (queries.shape[0], ANN_TOPK) or ids.min() < 0 or not np.isfinite(dists).all():
            raise RuntimeError(f"ann dense efS={efS}: ids {ids.shape} from {ids.min()}, or distances not finite")
        rec = recall_at(ids, true_ids)
        numbers[f"efS{efS}"] = {"recall": rec, "qps": queries.shape[0] / secs}
        print(f"ann dense predict efS={efS} [{smi}]: recall@{ANN_TOPK} {rec!r}, {queries.shape[0] / secs!r} QPS "
              f"(best of 2, {secs!r} s), {reads!r} host reads per {model.pred_params.batch_size}-query search")
    if numbers["efS100"]["recall"] < ANN_MIN_RECALL:
        raise RuntimeError(f"ann dense: recall@10 {numbers['efS100']['recall']!r} < {ANN_MIN_RECALL} at efS=100")
    # one chunk on the card and on the CPU over the same graph (batch composition changes results)
    Qc, kw = queries[:ANN_CPU_CHECK], dict(efS=100, topk=ANN_TOPK, batch_size=ANN_CPU_CHECK)
    ids_card, d_card = model.predict(Qc, **kw)
    t0 = time.perf_counter()
    ids_cpu, d_cpu = model.to("cpu").predict(Qc, **kw)
    cpu_s = time.perf_counter() - t0
    model.to(device)
    norms = float((base * base).sum(1).max() + (Qc * Qc).sum(1).max())
    check_ann_agreement(ids_card, ids_cpu, f"ann dense: id agreement with the CPU on {ANN_CPU_CHECK} queries "
                        f"(CPU search {cpu_s!r} s)", d_card, d_cpu, atol=1e-6 * norms)
    with tempfile.TemporaryDirectory(prefix="pecos_hnsw_") as folder:
        t0 = time.perf_counter()
        model.save(folder)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = HNSW.load(folder, device=device)
        ids_again, _ = loaded.predict(Qc, **kw)
        load_s = time.perf_counter() - t0
    check_ann_agreement(ids_again, ids_card, f"ann dense: saved ({save_s!r} s), loaded and searched again "
                        f"({load_s!r} s), ids equal to the first search")
    return model, base, queries, true_ids, numbers


def run_ann_pq(model, queries, true_ids, smi):
    """Phase 11b: PQ4 codes grafted onto phase 11a's graph; returns numbers."""
    import torch

    from pecos_tpu_torch.ann.hnsw import HNSWProductQuantizer4Bits

    t0 = time.perf_counter()
    pq = HNSWProductQuantizer4Bits.from_hnsw(model, num_subspaces=ANN_PQ_SUBSPACES)
    torch.cuda.synchronize()
    pq_s = time.perf_counter() - t0
    Qc, kw = queries[:ANN_PQ_CHECK], dict(efS=100, topk=ANN_TOPK, num_rerank=200)
    ids_un, d_un = pq.predict(Qc, packed="false", **kw)
    ids_pk, d_pk = pq.predict(Qc, packed="true", **kw)
    if not (np.array_equal(ids_un, ids_pk) and np.array_equal(d_un, d_pk)):
        raise RuntimeError(f"ann pq4: packed ids differ from unpacked in {int((ids_un != ids_pk).sum())} places")
    print(f"ann pq4 [{smi}]: from_hnsw S={ANN_PQ_SUBSPACES} in {pq_s!r} s; packed and unpacked ids equal on "
          f"{ANN_PQ_CHECK} queries (efS=100, num_rerank=200)")
    numbers = {"train_s": pq_s}
    for efS in ANN_PQ_EFS:
        (ids, dists), secs = best_time(lambda: pq.predict(queries, efS=efS, topk=ANN_TOPK, num_rerank=2 * efS))
        if ids.min() < 0 or not np.isfinite(dists).all():
            raise RuntimeError(f"ann pq4 efS={efS}: missing ids or distances not finite")
        rec = recall_at(ids, true_ids)
        numbers[f"efS{efS}"] = {"recall": rec, "qps": queries.shape[0] / secs}
        print(f"ann pq4 predict efS={efS} num_rerank={2 * efS} [{smi}]: recall@{ANN_TOPK} {rec!r}, "
              f"{queries.shape[0] / secs!r} QPS (best of 2, {secs!r} s)")
    if numbers["efS200"]["recall"] < ANN_PQ_MIN_RECALL:
        raise RuntimeError(f"ann pq4: recall@10 {numbers['efS200']['recall']!r} < {ANN_PQ_MIN_RECALL} at efS=200")
    return numbers


def run_ann_pairwise(base, device, smi):
    """Phase 11d: PairwiseANN over phase 11a's base with a random Y, the card against the CPU."""
    from pecos_tpu_torch.ann.pairwise import PairwiseANN

    rng = np.random.default_rng(SEED + 11)
    n = base.shape[0]
    Y = smat.csr_matrix(
        (rng.uniform(0.1, 1.0, size=3 * n).astype(np.float32), (np.repeat(np.arange(n), 3), rng.integers(0, ANN_LABELS, size=3 * n))),
        shape=(n, ANN_LABELS),
    )
    keys = rng.integers(0, ANN_LABELS, size=ANN_PAIRS).astype(np.uint32)
    Qp = base[rng.integers(0, n, size=ANN_PAIRS)] + rng.standard_normal((ANN_PAIRS, base.shape[1])).astype(np.float32)
    card = PairwiseANN.train(base, Y, metric_type="l2", device=device)
    (I, M, D, V), secs = best_time(lambda: card.predict(Qp, keys))
    Ic, Mc, Dc, Vc = PairwiseANN.train(base, Y, metric_type="l2", device="cpu").predict(Qp, keys)
    if not np.array_equal(M, Mc) or int(M.sum()) == 0:
        raise RuntimeError("ann pairwise: found masks differ from the CPU's, or nothing found")
    check_ann_agreement(I, Ic, f"ann pairwise [{smi}]: {ANN_PAIRS} (query, label) pairs over {n} rows, "
                        f"{ANN_LABELS} labels (up to {int(np.diff(Y.tocsc().indptr).max())} rows a label), "
                        f"{secs!r} s on the card; id agreement with the CPU", D, Dc,
                        atol=1e-6 * float((base * base).sum(1).max() + (Qp * Qp).sum(1).max()))
    return {"s": secs}


def run_ann_sparse(device, smi):
    """Phase 11c: the clustered sparse corpus, built and searched on the card
    through K1; returns (K1 launches of the build, of the efS=100 predict, numbers)."""
    import torch

    from pecos_tpu_torch.ann import HNSW
    from pecos_tpu_torch.ann.hnsw.graph import read_flag
    from pecos_tpu_torch.ops.intersect import intersect_scores

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="pecos_sparse_ann_") as folder:
        load_script("sparse_hnsw_bench").gen(folder, **ANN_SPARSE_DATA)
        X, Q = (smat.load_npz(os.path.join(folder, f"sparse_{w}.npz")).tocsr() for w in ("base", "queries"))
        gt_i, gt_d = (np.load(os.path.join(folder, f"sparse_gt_{w}.npy")) for w in ("i", "d"))
    X.sort_indices()
    Q.sort_indices()
    data_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reads0 = read_flag.syncs
    intersect_scores.launches = 0
    t0 = time.perf_counter()
    model = HNSW.train(X, metric_type="ip", data_type="csr", device=device, **ANN_BUILD)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = intersect_scores.launches
    peak = torch.cuda.max_memory_allocated() - mem0
    row_cap = model._device()[0].feats.shape[1]
    print(f"ann sparse: data {X.shape}, {X.nnz / X.shape[0]!r} nonzeros a row (row cap {row_cap}), {Q.shape[0]} queries, "
          f"made with its ground truth in {data_s!r} s")
    print(f"ann sparse build [{smi}]: ip, CSR, M={ANN_BUILD['M']} efC={ANN_BUILD['efC']}: {build_s!r} s, peak device "
          f"memory above the start {peak} bytes, {read_flag.syncs - reads0} host reads of loop flags, K1 launches {build_launches}")
    if row_cap != ANN_SPARSE_P:
        raise RuntimeError(f"ann sparse: row cap {row_cap} != {ANN_SPARSE_P}, the K1 HNSW cases' width")
    if build_launches <= 0:
        raise RuntimeError("ann sparse build: K1 was not launched")
    numbers = {"build_s": build_s, "peak_bytes": peak, "build_launches": build_launches}
    predict_launches = 0
    for efS in ANN_SPARSE_EFS:
        intersect_scores.launches = 0
        ids, dists = model.predict(Q, efS=efS, topk=ANN_TOPK)
        launches = intersect_scores.launches
        if efS == 100:
            predict_launches = launches
        (ids, dists), secs = best_time(lambda: model.predict(Q, efS=efS, topk=ANN_TOPK))
        if ids.min() < 0 or not np.isfinite(dists).all():
            raise RuntimeError(f"ann sparse efS={efS}: missing ids or distances not finite")
        rec, plain = sparse_tie_recall(ids, X, Q, gt_d), recall_at(ids, gt_i)
        numbers[f"efS{efS}"] = {"recall": rec, "plain_recall": plain, "qps": Q.shape[0] / secs}
        print(f"ann sparse predict efS={efS} [{smi}]: tie-aware recall@{ANN_TOPK} {rec!r} (plain {plain!r}), "
              f"{Q.shape[0] / secs!r} QPS (best of 2, {secs!r} s), K1 launches {launches}")
        if launches <= 0:
            raise RuntimeError(f"ann sparse predict efS={efS}: K1 was not launched")
    if numbers["efS100"]["recall"] < ANN_MIN_RECALL:
        raise RuntimeError(f"ann sparse: recall@10 {numbers['efS100']['recall']!r} < {ANN_MIN_RECALL} at efS=100")
    return build_launches, predict_launches, numbers


def print_profile(prof, wall_s, what, smi, top=14):
    """Device time by kernel from a torch.profiler run, its share of the wall
    time, and the host's launch and sync calls."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    t = lambda e: e.self_device_time_total
    total = sum(t(e) for e in dev)
    print(f"{what} profile [{smi}]: wall {wall_s!r} s, device time {total / 1e6!r} s "
          f"(busy {total / 1e6 / wall_s!r} of the wall), {sum(e.count for e in dev)} device operations")
    for e in sorted(dev, key=t, reverse=True)[:top]:
        print(f"  {t(e) / 1e3:10.1f} ms {100 * t(e) / max(total, 1):5.1f}% {e.count:8d}x {e.key[:90]}")
    host = {e.key: e for e in events if e.key in ("cudaLaunchKernel", "cudaStreamSynchronize", "cudaMemcpyAsync", "cudaDeviceSynchronize")}
    print("  host: " + ", ".join(f"{k} {e.count}x {e.cpu_time_total / 1e3:.1f} ms" for k, e in sorted(host.items())))


def profile_ann(device, smi):
    """``--profile-ann``: torch.profiler over one dense build (phase 11a's
    data) and one sparse predict at efS=100 (phase 11c's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pecos_tpu_torch.ann import HNSW

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    base, _ = load_script("ann_bench_data").make_data(**ANN_DENSE_DATA)
    HNSW.train(base[:8192], metric_type="l2", device=device, build_scan="true", **ANN_BUILD)  # first launches
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        HNSW.train(base, metric_type="l2", device=device, **ANN_BUILD)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print_profile(prof, wall, "ann dense build", smi)
    del prof
    with tempfile.TemporaryDirectory(prefix="pecos_sparse_ann_") as folder:
        load_script("sparse_hnsw_bench").gen(folder, **ANN_SPARSE_DATA)
        X, Q = (smat.load_npz(os.path.join(folder, f"sparse_{w}.npz")).tocsr() for w in ("base", "queries"))
    model = HNSW.train(X, metric_type="ip", data_type="csr", device=device, **ANN_BUILD)
    model.predict(Q, efS=100, topk=ANN_TOPK)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        model.predict(Q, efS=100, topk=ANN_TOPK)
        wall = time.perf_counter() - t0
    print_profile(prof, wall, "ann sparse predict efS=100", smi)


def batch_runner(compiled, X, device):
    """Phase 6's compute-only call: one BATCH-query padded batch already on
    the card through compiled.predict_padded."""
    import torch

    from pecos_tpu_torch.xmc.inference import prepare_queries_padded

    ids, vals = prepare_queries_padded(X[:BATCH], cap=Q_NNZ)
    ids_d, vals_d = torch.from_numpy(ids).to(device), torch.from_numpy(vals).to(device)
    pp_names = ("l3-hinge",) * compiled.depth
    has_dense = compiled.uses_dense_queries(BATCH, Q_NNZ)
    return lambda: compiled.predict_padded(
        ids_d, vals_d, beam_size=BEAM, only_topk=TOPK, pp_names=pp_names, has_dense=has_dense
    )


def profile_predict(device, smi, iters=20):
    """``--profile-predict``: torch.profiler over phase 6's batch loop (kernel
    time by name) and over one end-to-end predict of phase 5's queries (the
    device's traced busy share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    Ws, Cs = build_chain()
    X = make_queries()
    xlm = xlinear(Ws, Cs, device)
    run = batch_runner(xlm.model._get_compiled(), X, device)
    kw = dict(beam_size=BEAM, only_topk=TOPK)
    xlm.predict(X, **kw)  # warm
    run()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print_profile(prof, wall, f"predict batch loop ({iters} x {BATCH} queries)", smi)
    del prof
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        xlm.predict(X, **kw)
        wall = time.perf_counter() - t0
    print_profile(prof, wall, f"predict end to end ({N_QUERIES} queries)", smi)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke runs on a GPU only", file=sys.stderr)
        return 1
    from pecos_tpu_torch.ops import _build
    from pecos_tpu_torch.ops.intersect import intersect_scores

    # 1. device
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} (count {torch.cuda.device_count()}), torch {torch.__version__}, cuda {torch.version.cuda}")
    print(f"device: nvidia-smi {smi}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is True: fp32 matmuls would run in TF32")

    # 2. build
    secs = _build.build()
    with open(_build.LOG_PATH) as f:
        ptxas = " | ".join(l.strip() for l in f if "registers" in l or "bytes stack" in l)
    print(f"build: nvcc {secs:.2f} s -> {_build.LIB_PATH}; ptxas: {ptxas}")
    if sys.argv[1:] == ["--profile-ann"]:
        profile_ann(device, smi)
        return 0
    if sys.argv[1:] == ["--profile-predict"]:
        profile_predict(device, smi)
        return 0

    # 3. K1 against its plain version: over gathered blocks, then by row id
    max_err = max(check_k1(device), check_k1_rows(device))

    # 4. K1 timing by row id, at the main paths' shapes
    timed = {}
    for shape, N, K, P_, Qn, layout, pad, bias, R in K1_TIMED:
        t = time_k1(device, shape, N, K, P_, Qn, layout, pad, bias, R, iters=10 if N * K > 200_000 else 20)
        timed[shape] = t
        print(f"K1 timing {shape} (by id, N={N} K={K} P={P_} Qn={Qn}, table of {R} rows, L2 flushed, median of "
              f"CUDA events) [{smi}]: kernel {t['ms']!r} ms, bound {t['bound_ms']!r} ms ({t['bound_by']}, "
              f"{t['bytes']} bytes), share of bound {t['share']!r}; plain {t['plain_ms']!r} ms, "
              f"searchsorted composite {t['composite_ms']!r} ms")
    k_ms = timed["predict"]["ms"]
    gc.collect()
    torch.cuda.empty_cache()

    # 5. full-width predict
    t0 = time.perf_counter()
    Ws, Cs = build_chain()
    X = make_queries()
    xlm = xlinear(Ws, Cs, device)
    compiled = xlm.model._get_compiled()
    torch.cuda.synchronize()
    n_plabel = sum(l.kind == "plabel" for l in compiled.layers)
    print(f"predict: model {[l.kind for l in compiled.layers]} labels {compiled.nr_labels} "
          f"built and uploaded in {time.perf_counter() - t0:.1f} s")
    kw = dict(beam_size=BEAM, only_topk=TOPK)
    xlm.predict(X[:BATCH], **kw)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    intersect_scores.launches = 0
    P = xlm.predict(X, **kw)
    launches = intersect_scores.launches
    peak_bytes = torch.cuda.max_memory_allocated()
    xlm_cpu = xlinear(Ws, Cs, "cpu")
    P_cpu = xlm_cpu.predict(X[:N_CPU_CHECK], **kw)
    check_predict(P, P_cpu, L, N_QUERIES, n_plabel, BATCH, launches)
    print(f"predict: {N_QUERIES} queries -> {P.shape}, {P.nnz} entries, K1 launches {launches}")

    # 6. numbers
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        xlm.predict(X, **kw)
        best = min(best, time.perf_counter() - t0)
    run = batch_runner(compiled, X, device)
    run()
    iters = 20
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    end.synchronize()
    batch_ms = start.elapsed_time(end) / iters
    print(f"numbers [{smi}]: end-to-end {N_QUERIES / best!r} QPS (best of 3, {best!r} s for {N_QUERIES} queries)")
    print(f"numbers [{smi}]: compute {batch_ms!r} ms per {BATCH}-query batch "
          f"(K1 {n_plabel} x {k_ms!r} ms of it)")
    print(f"numbers [{smi}]: peak device memory {peak_bytes} bytes in the predict run")

    # 7. the compressed query wires
    wire_launches, _ = run_wire(xlm, xlm_cpu, X, P, n_plabel, smi, kw)
    del xlm_cpu
    gc.collect()

    # 8. realtime session, batch 1
    realtime_launches, _ = run_realtime(xlm, X, P, n_plabel, smi, kw)

    # 9. compiled folder, eager and lazy
    eager_launches, lazy_launches = run_compiled(compiled, X, P, n_plabel, smi, kw, device)
    del xlm, compiled
    gc.collect()
    torch.cuda.empty_cache()

    # 10. training: solvers, the golden fixture, the matched-recall benchmark
    check_solvers(device, smi)
    golden_launches = run_golden(device, smi)
    train_launches, _ = run_matched_recall(device, smi)
    gc.collect()
    torch.cuda.empty_cache()

    # 11. ANN: dense HNSW build and search, PQ4 on its graph, sparse HNSW through K1, PairwiseANN
    hnsw, base, queries, true_ids, _ = run_ann_dense(device, smi)
    run_ann_pq(hnsw, queries, true_ids, smi)
    del hnsw, queries, true_ids
    gc.collect()
    torch.cuda.empty_cache()
    sparse_build_launches, sparse_predict_launches, _ = run_ann_sparse(device, smi)
    run_ann_pairwise(base, device, smi)

    print(f"gpu: {smi}")
    pred = timed["predict"]
    kernels = [{
        "name": "intersect_scores", "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
        "launches": launches, "max_abs_err": max_err, "ms": pred["ms"], "plain_ms": pred["plain_ms"],
        "bound_ms": pred["bound_ms"], "bound_by": pred["bound_by"], "library_ms": None,
        "share": pred["share"], "composite_ms": pred["composite_ms"],
        "shapes": {shape: {k: t[k] for k in ("N", "K", "P", "Qn", "ms", "plain_ms", "composite_ms", "bound_ms", "bound_by", "share")}
                   for shape, t in timed.items()},
        "launches_by_path": {
            "predict": launches, **{f"wire_{dt}": n for dt, n in wire_launches.items()},
            "realtime": realtime_launches, "compiled_eager": eager_launches, "compiled_lazy": lazy_launches,
            "train_golden": golden_launches, "train_predict": train_launches,
            "ann_sparse_build": sparse_build_launches, "ann_sparse_predict": sparse_predict_launches,
        },
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
