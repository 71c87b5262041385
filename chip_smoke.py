"""Smoke run of the PyTorch + CUDA port (pecos_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                      # phases 1-13, the result lines last
    python3 chip_smoke.py --profile-text2text  # phases 1-2, then cProfile over one phase-13b member's train and torch.profiler over its predict
    python3 chip_smoke.py --profile-ann        # phases 1-2, then torch.profiler over phase 11's dense build and sparse predict
    python3 chip_smoke.py --profile-predict    # phases 1-2, then torch.profiler over phase 6's batch loop and one predict
    python3 chip_smoke.py --f8-cost PARENT     # phases 1-2, then the F8 solve and one phase-13b member's train under PARENT's package and this one's

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
             the on-device latency of one beam walk, which must not exceed
             the p50 (each timed walk queued behind a sleep of the card).
9. compiled — save_compiled_layers of the phase-5 model to a temporary
             directory; load_compiled_layers eager (labels of 1,024 queries
             equal phase 5's) and lazy with every layer streamed (agreement
             with eager; peak memory below the resident layers' bytes).
10. train  — (a) the Newton-CG solvers on the card against the port on the
             CPU (solve_block_coded, solve_cluster_bucket, solve_sparse_rows
             in both layouts) and host syncs per solve, and F8: the chunked
             solve_sparse_rows above the dense budget twice on the card, W
             bit-equal, and against the CPU; (b) the golden fixture
             (tests/data) indexed and trained on the card, precision held to
             the golden run's, and once more with tfn+man negatives held to
             the same run on the CPU; (c) the repo's matched-recall training
             benchmark at full width (scripts/xmc_bench.py: 20,000 x 4,096
             train, 8,192 labels, 16-way tree, leaves of 100): PIFA and the
             clustering on the card (twice: one seed must give one chain),
             XLinearModel.train twice, then 4,000 test queries predicted
             through K1 (beam 10, top 10), P@1 >= 0.80.
11. ann    — the repo's ANN geometries (benchmarks/README.md:42-133): (a)
             synthetic SIFT, 100,000 x 128, l2, M=32, efC=100, built on the
             card with the defaults (scan mode, bfloat16 search copy), exact
             top-10 by a float64 matmul, recall@10 >= 0.99 at efS=100 of
             10,000 queries, QPS at efS 50/100/200, 256 queries searched on
             the card and on the CPU over the graph (>= 99% equal ids), saved,
             loaded, searched again; (b) PQ4 (64 subspaces) grafted onto that
             graph twice (one seed must give the same codes and codebooks),
             packed and unpacked ids equal on 1,000 queries, recall@10
             >= 0.95 at efS=200 (num_rerank 2 x efS); (c) the clustered sparse
             corpus (100,000 x 500,000 CSR, ip) built and searched through K1,
             tie-aware recall@10 >= 0.99 at efS=100; (d) PairwiseANN on (a)'s
             base with a random Y, the card against the CPU.
12. multi-device — a mesh of 4 shards over the cards, or over the one card
             four times (pecos_tpu_torch.parallel): (a) the mesh's dry run;
             (b) phase 5's model and queries through XLinearModel.predict with
             mesh= at lp=4: K1 once per plabel level, shard and batch, labels
             >= 99.5% equal to phase 5's; (c) the dense engines
             (data-parallel and label-sharded) on phase 10c's model and dense
             test queries against its single-device predict; (d)
             DistributedXLinearModel.train on phase 10c's data with 2 thread
             ranks (FakeClusterComm), P@1 >= 0.80 and within 0.02 of 10c's.
13. text2text — (a) the native Tfidf (word 1-2 grams) at the repo's
             tokenizer benchmark protocol (scripts/tokenizer_bench.py: 100,000
             Zipf documents): train and predict docs/s, X's shape and nnz
             beside the JAX package's record, and the gate: the first 2,000
             documents vectorized natively and by the plain Python version
             give equal CSR; (b) Text2Text on that corpus with 8,192 items
             drawn onto it (90,000 train, 10,000 test lines): trained on the
             card (two PIFA members, rank_average), test P@1 and P@5 within
             0.02 of the JAX package's on the same files, K1 launched once per
             plabel level, batch and member, end-to-end QPS split into
             vectorize / XLinearModel.predict / ensemble; saved and loaded on
             the card (equal items) and on the CPU, where a plain
             sparse-product beam search gives >= 99.5% equal items and each
             member's scores within rtol 1e-5 + 1e-5 x the largest; then K1
             at the path's shapes: 64 test queries at every plabel level of
             each member, over the padded tables the predict reads, against
             the sparse product at the candidate columns.

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
# F8: (P, xcap, Db, ns) of a solve_sparse_rows above the dense budget, P * (Db + 2) > 2**28
F8_SOLVE = (2048, 32, 140_000, 16)
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
# phase 12: a mesh of 4 shards; the distributed train's thread ranks and its
# P@1 window around the direct train's
SHARDS, DIST_RANKS, DIST_P1_WINDOW = 4, 2, 0.02
# phase 13: the repo's tokenizer benchmark protocol (scripts/tokenizer_bench.py:24-39,
# :81-82) and the JAX package's record of its TF-IDF matrix (benchmarks/tokenizer_tfidf.json)
T2T_CORPUS = dict(n_docs=100_000, vocab=50_000, mean_len=60)
T2T_VECTORIZER = {"type": "tfidf", "kwargs": {"base_vect_configs": [{"analyzer": "word", "ngram_range": [1, 2]}]}}
T2T_JAX_RECORD = dict(shape=(100_000, 2_977_638), nnz=10_863_842)
T2T_GATE_DOCS = 2000  # native against the plain tokenizer
# phase 13b: labels drawn onto that corpus; the Text2Text train settings
T2T_ITEMS, T2T_N_TRN, T2T_KEYWORD_P = 8192, 90_000, 0.8
T2T_TRAIN = dict(
    label_embed_type=["pifa"], ensemble_seeds=[0, 1], ens_method="rank_average",
    vectorizer_config=T2T_VECTORIZER, indexer_kwargs=dict(MR_INDEX),
)
T2T_BEAM, T2T_TOPK = 10, 10
# Test P@1 and P@5 of the JAX package's Text2Text trained with T2T_TRAIN on
# make_t2t_files' files (corpus digest T2T_DIGEST) on a CPU, scored by a plain
# beam search built from the JAX package's own post-processor, children
# tables and ensembler: `JAX_PLATFORMS=cpu python tests/text2text_reference.py
# --workdir DIR` (PERF.md section 4).  The card has no jax, so the result is
# written here.
T2T_REF_PREC = (0.7288, 0.23798000000001007)
T2T_DIGEST = "7de09c0a76e1cea8"
T2T_PREC_WINDOW, T2T_MIN_CPU_AGREE = 0.02, 0.995
# the card's member scores against the plain predict's on the (row, label)
# entries both hold: rtol, and atol as a share of the largest plain score
T2T_SCORE_RTOL, T2T_SCORE_ATOL = 1e-5, 1e-5
T2T_K1_QUERIES = 64  # test queries K1 scores at each plabel level against the sparse product


def corpus_digest(corpus):
    """First 16 hex digits of the sha256 of the corpus's lines: a numpy that
    draws another corpus from the seed shows here."""
    import hashlib

    return hashlib.sha256("\n".join(corpus).encode()).hexdigest()[:16]


def make_t2t_files(folder, corpus, seed=SEED):
    """Phase 13b's data in ``folder``: items.txt (T2T_ITEMS lines ``item {j}
    kw{j:05d}``), train.txt (the first T2T_N_TRN documents) and test.txt (the
    rest), each line ``l1,l2\\ttext``.  Each document gets 1-3 labels drawn
    Zipf over the items; each label's keyword takes the place of one of the
    document's words with probability T2T_KEYWORD_P.  Returns the paths
    (items, train, test)."""
    rng = np.random.default_rng(seed + 13)
    n = len(corpus)
    p = 1.0 / np.arange(1, T2T_ITEMS + 1)
    p /= p.sum()
    n_lab = rng.integers(1, 4, size=n)
    labels = rng.choice(T2T_ITEMS, size=int(n_lab.sum()), p=p)
    put = rng.uniform(size=len(labels)) < T2T_KEYWORD_P
    where = rng.integers(0, 1 << 30, size=len(labels))
    lines, ofs = [], 0
    for i, text in enumerate(corpus):
        words = text.split(" ")
        mine = slice(ofs, ofs + n_lab[i])
        for lab, ok, w in zip(labels[mine], put[mine], where[mine]):
            if ok:
                words[w % len(words)] = f"kw{lab:05d}"
        lines.append(",".join(str(l) for l in sorted(set(labels[mine].tolist()))) + "\t" + " ".join(words))
        ofs += n_lab[i]
    paths = [os.path.join(folder, f) for f in ("items.txt", "train.txt", "test.txt")]
    for path, rows in zip(paths, ([f"item {j} kw{j:05d}" for j in range(T2T_ITEMS)], lines[:T2T_N_TRN], lines[T2T_N_TRN:])):
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n".join(rows) + "\n")
    return paths


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
          f"on-device {on_device!r} ms per beam walk (32 chained walks, each between CUDA events behind a "
          f"sleep of the card); K1 launches per call {launches // N_REALTIME}")
    if not on_device <= p50:
        raise RuntimeError(f"realtime: on-device walk {on_device!r} ms > call p50 {p50!r} ms: it holds host time")
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


def f8_inputs():
    """(ids, vals, y, c) of the F8 solve: half of each row's ids from 2,000
    shared features, so runs of one id are long; padded slots hold Db."""
    P, xcap, Db, ns = F8_SOLVE
    rng = np.random.default_rng(SEED + 8)
    half = xcap // 2
    ids = np.concatenate([unique_rows(rng, P, half, 2000), 2000 + unique_rows(rng, P, xcap - half, Db - 2000)], axis=1)
    ids[::3, -4:] = Db
    vals = np.where(ids < Db, rng.standard_normal((P, xcap)), 0.0).astype(np.float32)
    y = np.where(rng.uniform(size=(P, ns)) < 0.3, 1.0, -1.0).astype(np.float32)
    c = rng.uniform(0.5, 1.5, size=(P, ns)).astype(np.float32)
    return ids, vals, y, c


def check_f8_solve(device, smi):
    """Phase 10a, F8: solve_sparse_rows at a shape above the dense budget, so
    the chunked layout runs as a large train runs it: twice on the card with
    bit-equal W, and within SOLVER_ATOL of the CPU (inputs: f8_inputs)."""
    import torch

    from pecos_tpu_torch.xmc import solvers

    P, xcap, Db, ns = F8_SOLVE
    if P * (Db + 2) <= solvers._GLOBAL_DENSE_BUDGET:
        raise RuntimeError(f"F8 solve: P * (Db + 2) = {P * (Db + 2)} fits the dense layout")
    out, secs = [], []
    for dev in (device, device, torch.device("cpu")):
        args = [torch.from_numpy(a).to(dev) for a in f8_inputs()]
        t0 = time.perf_counter()
        out.append(solvers.solve_sparse_rows(*args, Db=Db, **TIGHT).cpu().numpy())
        secs.append(time.perf_counter() - t0)
    same = np.array_equal(out[0], out[1])
    err = float(np.abs(out[0] - out[2]).max())
    print(f"train solvers F8 [{smi}]: solve_sparse_rows chunked (P {P} x (Db {Db} + 2) = {P * (Db + 2)} > "
          f"{solvers._GLOBAL_DENSE_BUDGET}), W {out[0].shape}: two solves on the card bit-equal {same} "
          f"({secs[0]!r} / {secs[1]!r} s); max_abs_err vs CPU {err!r} ({secs[2]!r} s on the CPU)")
    if not same:
        raise RuntimeError("F8 solve: two chunked solves on the card differ")
    if not (err <= SOLVER_ATOL and np.isfinite(out[0]).all()):
        raise RuntimeError(f"F8 solve: W differs from the CPU's by {err!r} > {SOLVER_ATOL}")


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
    feats = LabelEmbeddingFactory.create(Y, X, method="pifa")
    chain = Indexer.gen(feats, device=device, **MR_INDEX)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = Indexer.gen(feats, device=device, **MR_INDEX)
    torch.cuda.synchronize()
    again_s = time.perf_counter() - t0
    same = len(again) == len(chain) and all(a.shape == b.shape and (a != b).nnz == 0 for a, b in zip(chain, again))
    print(f"train matched-recall F8 [{smi}]: Indexer.gen twice on the card with one seed: chains equal {same} "
          f"(second gen {again_s!r} s)")
    if not same:
        raise RuntimeError("train matched-recall: one seed gave two chains on the card")
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
        "model": model, "chain": chain, "data": (X, Y, Xt, Yt),
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
    again = HNSWProductQuantizer4Bits.from_hnsw(model, num_subspaces=ANN_PQ_SUBSPACES).pq
    differ = int((again.codes != pq.pq.codes).sum())
    print(f"ann pq4 F8 [{smi}]: train_pq4 twice on the card with one seed: {differ} of {pq.pq.codes.size} codes "
          f"differ, codebooks equal {np.array_equal(again.codebooks, pq.pq.codebooks)}")
    if differ or not np.array_equal(again.codebooks, pq.pq.codebooks):
        raise RuntimeError("ann pq4: one seed gave two quantizers on the card")
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


def run_dryrun(smi):
    """Phase 12a: the mesh's dry run on SHARDS shards."""
    from pecos_tpu_torch.parallel.dryrun import dryrun
    from pecos_tpu_torch.parallel.mesh import cuda_devices, make_mesh

    t0 = time.perf_counter()
    out = dryrun(make_mesh(devices=cuda_devices(SHARDS)))
    print(f"multi-device dryrun [{smi}]: {out['mesh']} in {time.perf_counter() - t0!r} s")


def run_sharded_predict(xlm, X, P5, n_plabel, smi, kw):
    """Phase 12b: phase 5's model and queries through the label-sharded
    sparse engine at lp=SHARDS; returns its K1 launches."""
    import torch

    from pecos_tpu_torch.ops.intersect import intersect_scores
    from pecos_tpu_torch.parallel.mesh import cuda_devices, make_mesh, mesh_layers

    mesh = make_mesh(SHARDS, dp=1, devices=cuda_devices(SHARDS))
    compiled = xlm.model._get_compiled()
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    xlm.predict(X[:BATCH], mesh=mesh, **kw)  # lays the layers out on the mesh once, and warms
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t0
    intersect_scores.launches = 0
    P = xlm.predict(X, mesh=mesh, **kw)
    launches = intersect_scores.launches
    peak = torch.cuda.max_memory_allocated()
    want = n_plabel * SHARDS * mesh.shape["dp"] * -(-N_QUERIES // BATCH)
    if launches != want:
        raise RuntimeError(f"sharded predict: K1 launched {launches} times, expected {want} (plabel levels x shards x batches)")
    if P.shape != (N_QUERIES, L):
        raise RuntimeError(f"sharded predict: prediction shape {P.shape}")
    labels, scores = ranked(P, TOPK)
    want_labels, want_scores = ranked(P5, TOPK)
    check_agreement(labels, scores, want_labels, want_scores, f"sharded predict [{smi}]: (row, rank) labels equal to phase 5's")
    same = labels == want_labels
    rel = float((np.abs(scores[same] - want_scores[same]) / np.maximum(np.abs(want_scores[same]), 1e-30)).max())
    shard_bytes = [sum(l.nbytes for l in layers) for layers in mesh_layers(compiled, mesh, "parents")[0]]
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        xlm.predict(X, mesh=mesh, **kw)
        best = min(best, time.perf_counter() - t0)
    print(f"sharded predict [{smi}]: mesh {mesh.shape} on {sorted({str(d) for d in mesh.devices[0]})}, layers laid out "
          f"and warmed in {layout_s!r} s; {N_QUERIES} queries: K1 launches {launches} ({n_plabel} plabel levels x "
          f"{SHARDS} shards x {-(-N_QUERIES // BATCH)} batches); largest score rel diff from phase 5 {rel!r}")
    print(f"sharded predict [{smi}]: end-to-end {N_QUERIES / best!r} QPS (best of 3, {best!r} s); largest shard "
          f"{max(shard_bytes)} bytes (single-device layers {sum(l.nbytes for l in compiled.layers)} bytes); peak device "
          f"memory {peak} bytes, {peak - base} above the start")
    return launches


def run_dense_engines(model, Xt, smi):
    """Phase 12c: the data-parallel and the label-sharded dense engines on
    the matched-recall model, against its single-device predict of the same
    dense queries."""
    import torch

    from pecos_tpu_torch.parallel.mesh import cuda_devices, make_mesh, shard_chain_predict, shard_chain_predict_labels

    mesh = make_mesh(devices=cuda_devices(SHARDS))
    compiled = model.model._get_compiled()
    Xd = Xt.toarray()
    kw = dict(beam_size=MR_BEAM, only_topk=MR_TOPK)
    want_labels, want_scores = ranked(model.predict(Xd, **kw), MR_TOPK)
    for name, fn in (("shard_chain_predict", shard_chain_predict), ("shard_chain_predict_labels", shard_chain_predict_labels)):
        fn(mesh, compiled, Xd[: 8 * mesh.size], **kw)  # lays the layers out, and warms
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels, vals = fn(mesh, compiled, Xd, **kw)
        labels, vals = labels.cpu().numpy(), vals.cpu().numpy()
        secs = time.perf_counter() - t0
        rows = int((labels == want_labels).all(axis=1).sum())
        check_agreement(labels, vals, want_labels, want_scores, f"{name} [{smi}]: mesh {mesh.shape}, {Xd.shape[0]} dense "
                        f"queries in {secs!r} s, rows equal to the single-device predict {rows} of {Xd.shape[0]}; (row, rank) labels equal")


def run_dist_train(numbers, smi, device):
    """Phase 12d: DistributedXLinearModel.train on phase 10c's data, DIST_RANKS
    FakeClusterComm ranks as threads on the card; P@1 held to 10c's."""
    import threading
    import traceback

    import torch

    from pecos_tpu_torch.distributed.xmc import DistClustering
    from pecos_tpu_torch.distributed.xmc.xlinear import DistributedXLinearModel
    from pecos_tpu_torch.parallel.comm import FakeClusterComm
    from pecos_tpu_torch.utils import smat_util

    X, Y, Xt, Yt = numbers["data"]
    cluster = FakeClusterComm(DIST_RANKS)
    results, errors = [None] * DIST_RANKS, []

    def rank(r):
        try:
            comm = cluster.rank_comm(r)
            dist = DistClustering.dist_get_cluster_chain(X, Y, comm, {"indexer_params": MR_INDEX}, device=device)
            results[r] = (DistributedXLinearModel.train(X, Y, comm, dist_chain=dist, device=device), dist)
        except Exception:
            errors.append(traceback.format_exc())
            raise

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(DIST_RANKS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads) or results[0][0] is None:
        raise RuntimeError("distributed train: a rank failed or did not finish\n" + "\n".join(errors))
    model, dist = results[0]
    chain = dist.get_cluster_chain()
    direct = numbers["chain"]
    same_chain = len(chain) == len(direct) and all(a.shape == b.shape and (a != b).nnz == 0 for a, b in zip(chain, direct))
    P = model.predict(Xt, beam_size=MR_BEAM, only_topk=MR_TOPK)
    p1, direct_p1 = float(smat_util.Metrics.generate(Yt, P, topk=MR_TOPK).prec[0]), numbers["prec"][0]
    print(f"distributed train [{smi}]: {DIST_RANKS} FakeClusterComm ranks on the card, {X.shape[0]} x {Y.shape[1]}: "
          f"{secs!r} s (clustering and train); chain {[C.shape for C in chain]} split at depth {dist.get_split_depth()}, "
          f"equal to phase 10c's Indexer.gen chain: {same_chain}")
    print(f"distributed train [{smi}]: P@1 {p1!r} on {Xt.shape[0]} held-out queries (direct train {direct_p1!r})")
    if p1 < MR_MIN_P1 or abs(p1 - direct_p1) > DIST_P1_WINDOW:
        raise RuntimeError(f"distributed train: P@1 {p1!r} below {MR_MIN_P1} or more than {DIST_P1_WINDOW} from {direct_p1!r}")


def run_tfidf():
    """Phase 13a: the native Tfidf at the repo's tokenizer-benchmark protocol
    (host only); returns the corpus."""
    from pecos_tpu_torch import core
    from pecos_tpu_torch.utils.featurization.text import Vectorizer

    core_s = core.build()
    t0 = time.perf_counter()
    corpus = load_script("tokenizer_bench").make_corpus(**T2T_CORPUS)
    digest = corpus_digest(corpus)
    print(f"tfidf: host core g++ {core_s:.2f} s -> {core.LIB_PATH}; corpus of {len(corpus)} documents in "
          f"{time.perf_counter() - t0!r} s, digest {digest} (the reference's {T2T_DIGEST}: equal {digest == T2T_DIGEST})")
    if digest != T2T_DIGEST:  # the JAX record and T2T_REF_PREC hold for that corpus only
        raise RuntimeError(f"tfidf: corpus digest {digest}, not the reference's {T2T_DIGEST}: numpy drew another corpus")
    t0 = time.perf_counter()
    model = Vectorizer.train(corpus, config=T2T_VECTORIZER)
    cold_s = time.perf_counter() - t0
    model, train_s = best_time(lambda: Vectorizer.train(corpus, config=T2T_VECTORIZER))
    X, predict_s = best_time(lambda: model.predict(corpus))
    shape, nnz = tuple(X.shape), int(X.nnz)
    print(f"tfidf: train {len(corpus) / train_s!r} docs/s ({train_s!r} s warm, best of 2; cold {cold_s!r} s), predict "
          f"{len(corpus) / predict_s!r} docs/s ({predict_s!r} s, best of 2); X {shape}, nnz {nnz} (the JAX package's "
          f"record {T2T_JAX_RECORD['shape']}, nnz {T2T_JAX_RECORD['nnz']}: equal {(shape, nnz) == (T2T_JAX_RECORD['shape'], T2T_JAX_RECORD['nnz'])})")
    if (shape, nnz) != (T2T_JAX_RECORD["shape"], T2T_JAX_RECORD["nnz"]):
        raise RuntimeError(f"tfidf: the reference's corpus gave {shape}, nnz {nnz}, not the JAX package's record")
    gate = corpus[:T2T_GATE_DOCS]
    native, plain = X[:T2T_GATE_DOCS], model.model.predict_plain(gate)
    same = (np.array_equal(native.indptr, plain.indptr) and np.array_equal(native.indices, plain.indices)
            and np.allclose(native.data, plain.data, rtol=1e-6, atol=0.0))
    err = float(np.abs(native.data - plain.data).max()) if same else float("nan")
    print(f"tfidf gate: the first {T2T_GATE_DOCS} documents, native against the plain Python version with the trained "
          f"vocabulary: indptr and indices equal, data within rtol 1e-6: {same} (max abs diff {err!r})")
    if not same:
        raise RuntimeError("tfidf gate: the native tokenizer and its plain version disagree")
    return corpus


def plain_xlinear_predict(xlm, X, beam_size, only_topk, block=2048, beams=None):
    """The beam search of an XLinearModel over its host matrices, in
    numpy/scipy: the plain reference of phase 13b.  Each level's raw scores
    are one sparse product X @ W over the real nonzeros (no padded layout, no
    K1); then the level's transform, the combiner with the parent's path
    value, and a stable descending sort of the candidates in children-table
    order (ascending ids within a parent), as ``inference.select_beam`` takes
    them.  Returns the top-``only_topk`` CSR, each row in rank order; the
    parents (-1 for none) that enter each level for the first ``block`` rows
    are appended to ``beams`` when it is a list."""
    from pecos_tpu_torch.utils import smat_util
    from pecos_tpu_torch.utils.cluster_util import padded_children
    from pecos_tpu_torch.xmc.postprocessor import PostProcessor

    chain = xlm.model.model_chain
    pps = [PostProcessor.get(q.post_processor) for q in xlm.model.pred_params.model_chain]
    X = X.tocsr().astype(np.float32)
    if chain[0].bias > 0:
        X = smat.hstack([X, smat.csr_matrix(np.full((X.shape[0], 1), chain[0].bias, np.float32))], format="csr")
    Ws = [m.W.tocsc().astype(np.float32) for m in chain]
    kids = [padded_children(m.C)[0].astype(np.int64) for m in chain]
    labels, values = [], []
    for s in range(0, X.shape[0], block):
        xb = X[s : s + block]
        n = xb.shape[0]
        parents = np.tile(np.arange(kids[0].shape[0]), (n, 1))
        pvals = np.full(parents.shape, pps[0].init_value, np.float32)
        for d, (W, children, pp) in enumerate(zip(Ws, kids, pps)):
            if beams is not None and s == 0:
                beams.append(parents)
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


def ensemble_topk(model, preds, topk):
    """The members' top-k CSRs combined as Text2Text.predict combines them."""
    from pecos_tpu_torch.utils import smat_util

    P = preds[0] if len(preds) == 1 else getattr(smat_util.CsrEnsembler, model.ens_method)(*preds)
    return smat_util.sorted_csr(P.tocsr(), only_topk=topk)


def check_scores(got, want, what):
    """The scores of the (row, label) entries two top-k CSRs both hold,
    within T2T_SCORE_RTOL x |want| + T2T_SCORE_ATOL x max |want|; returns
    (entries compared, max abs err) and raises outside the tolerance."""
    got, want = got.tocoo(), want.tocoo()
    keys = [a.row.astype(np.int64) * a.shape[1] + a.col for a in (got, want)]
    _, ig, iw = np.intersect1d(*keys, assume_unique=True, return_indices=True)
    err = np.abs(got.data[ig].astype(np.float64) - want.data[iw])
    tol = T2T_SCORE_RTOL * np.abs(want.data[iw]) + T2T_SCORE_ATOL * float(np.abs(want.data).max(initial=0.0))
    bad, max_err = int((err > tol).sum()), float(err.max(initial=0.0))
    print(f"{what}: {len(ig)} of {want.nnz} (row, label) entries in both, max_abs_err {max_err!r} "
          f"(largest score {float(np.abs(want.data).max(initial=0.0))!r}), bad {bad}")
    if bad or not np.isfinite(got.data).all():
        raise RuntimeError(f"{what}: {bad} scores outside rtol {T2T_SCORE_RTOL} + atol {T2T_SCORE_ATOL} x max")
    return len(ig), max_err


def check_k1_text2text(members, host_members, X, n=T2T_K1_QUERIES):
    """K1 at phase 13b's shapes: the first ``n`` rows of ``X`` scored at every
    plabel level of each member by the path's call
    (``inference.score_candidates_sparse_parents`` on the member's padded
    ``parent_packed`` table), over the beam parents the plain predict chose
    for them, against the sparse product X @ W at the candidate columns in
    float64 (0 where a parent has no such child); ``host_members`` hold the
    same weights as host matrices.  Tolerance as check_k1's.  Returns the max
    abs error."""
    import torch

    from pecos_tpu_torch.utils.cluster_util import padded_children
    from pecos_tpu_torch.xmc import inference

    A = X[:n].tocsr().astype(np.float32)
    n, worst = A.shape[0], 0.0
    for i, (xlm, host) in enumerate(zip(members, host_members)):
        compiled = xlm.model._get_compiled()
        D, bias, dev = compiled.nr_features, compiled.bias, compiled.device
        beams = []
        plain_xlinear_predict(host, A, T2T_BEAM, max(T2T_TOPK, 10), beams=beams)
        q, v = (torch.from_numpy(a).to(dev) for a in inference.prepare_queries_padded(A))
        Xb = A.astype(np.float64)
        if bias > 0:
            Xb = smat.hstack([Xb, smat.csr_matrix(np.full((n, 1), bias))], format="csr")
        for d, (layer, m) in enumerate(zip(compiled.layers, host.model.model_chain)):
            if layer.kind != "plabel":
                continue
            parents = np.clip(beams[d], 0, None).astype(np.int64)  # as expand_beam clamps them
            got = inference.score_candidates_sparse_parents(
                q, v, layer, torch.from_numpy(parents).to(dev), D if bias > 0 else None, bias
            ).cpu().numpy()
            cand = padded_children(m.C)[0][parents].reshape(n, -1).astype(np.int64)
            cols, W = np.clip(cand, 0, None), m.W.tocsc().astype(np.float64)
            want = np.where(cand >= 0, np.take_along_axis((Xb @ W).toarray(), cols, axis=1), 0.0)
            scale = float(np.take_along_axis((abs(Xb) @ abs(W)).toarray(), cols, axis=1).max())
            err = np.abs(got - want)
            bad = int((err > 1e-5 * np.abs(want) + 1e-6 * scale).sum())
            print(f"K1 text2text member {i} level {d}: N={n} K={cand.shape[1]} table {tuple(layer.parent_packed.shape)} "
                  f"({layer.parent_packed.numel()} int32), Qn={q.shape[1]}: max_abs_err={float(err.max())!r} "
                  f"scale={scale!r} bad={bad}")
            if bad or not np.isfinite(got).all():
                raise RuntimeError(f"K1 text2text member {i} level {d}: {bad} scores outside tolerance")
            worst = max(worst, float(err.max()))
    return worst


class CallTimes:
    """Seconds of each call of the classmethod ``cls.name`` while active,
    the card synchronized before the clock stops."""

    def __init__(self, cls, name):
        self.cls, self.name, self.seconds = cls, name, []

    def __enter__(self):
        import torch

        self._orig = self.cls.__dict__[self.name]
        fn = self._orig.__func__

        def timed(klass, *args, **kwargs):
            t0 = time.perf_counter()
            out = fn(klass, *args, **kwargs)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            return out

        setattr(self.cls, self.name, classmethod(timed))
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self._orig)


def run_text2text(device, smi, corpus):
    """Phase 13b: Text2Text trained and served on the card on phase 13a's
    corpus with labels; returns the K1 launches of the test predict and
    K1's max abs error at the path's shapes."""
    import torch

    from pecos_tpu_torch.apps.text2text import Text2Text
    from pecos_tpu_torch.ops.intersect import intersect_scores
    from pecos_tpu_torch.utils import smat_util
    from pecos_tpu_torch.utils.featurization.text import Preprocessor
    from pecos_tpu_torch.xmc import Indexer
    from pecos_tpu_torch.xmc.xlinear import XLinearModel

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        items, trn, tst = make_t2t_files(tmp, corpus)
        print(f"text2text: {T2T_ITEMS} items, {T2T_N_TRN} train and {len(corpus) - T2T_N_TRN} test lines written in "
              f"{time.perf_counter() - t0!r} s")
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with CallTimes(Indexer, "gen") as gen_s, CallTimes(XLinearModel, "train") as train_s, SolveCounter() as count:
            t0 = time.perf_counter()
            model = Text2Text.train(trn, items, device=device, **T2T_TRAIN)
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
        train_peak = torch.cuda.max_memory_allocated() - base
        members = model.xlinear_models
        kinds = [[l.kind for l in m.model._get_compiled().layers] for m in members]
        print(f"text2text train [{smi}]: {total_s!r} s in all; per member index (PIFA clustering) {gen_s.seconds!r} s, "
              f"XLinearModel.train {train_s.seconds!r} s; the rest (parse, Tfidf, PIFA) "
              f"{total_s - sum(gen_s.seconds) - sum(train_s.seconds)!r} s; {count.solves} solves; X has "
              f"{model.preprocessor.vectorizer.model.nr_features} features; layers {kinds}; peak device memory above "
              f"the start {train_peak} bytes")

        parsed = Preprocessor.load_data_from_file(tst, label_text_path=items)
        texts, Yt = parsed["corpus"], parsed["label_matrix"]
        kw = dict(topk=T2T_TOPK, beam_size=T2T_BEAM)
        torch.cuda.reset_peak_memory_stats()
        intersect_scores.launches = 0
        P = model.predict(texts, ret_csr=True, **kw)
        launches = intersect_scores.launches
        predict_peak = torch.cuda.max_memory_allocated()
        n_plabel = sum(k.count("plabel") for k in kinds)
        want_launches = n_plabel * -(-len(texts) // BATCH)
        labels, scores = ranked(P, T2T_TOPK)
        if P.shape != (len(texts), T2T_ITEMS) or not np.isfinite(scores).all():
            raise RuntimeError(f"text2text predict: {P.shape}, finite {np.isfinite(scores).all()}")
        m = smat_util.Metrics.generate(Yt, P, topk=T2T_TOPK)
        prec = [float(m.prec[0]), float(m.prec[4])]
        print(f"text2text predict [{smi}]: {len(texts)} test texts, beam {T2T_BEAM}, top {T2T_TOPK}: P@1 {prec[0]!r}, "
              f"P@5 {prec[1]!r}, recall@10 {float(m.recall[9])!r} (the reference's P@1, P@5 {T2T_REF_PREC}); K1 launches "
              f"{launches} (expected {want_launches}: plabel levels {n_plabel} over {len(members)} members x "
              f"{-(-len(texts) // BATCH)} batches); peak device memory {predict_peak} bytes")
        if launches != want_launches or launches <= 0:
            raise RuntimeError(f"text2text predict: K1 launched {launches} times, expected {want_launches}")
        if T2T_REF_PREC is None or any(abs(a - b) > T2T_PREC_WINDOW for a, b in zip(prec, T2T_REF_PREC)):
            raise RuntimeError(f"text2text predict: P@1, P@5 {prec} not within {T2T_PREC_WINDOW} of {T2T_REF_PREC}")

        items_out, e2e_s = best_time(lambda: model.predict(texts, **kw))
        if [[it for it, _ in row] for row in items_out[:3]] != [[model.output_items[j] for j in row] for row in labels[:3]]:
            raise RuntimeError("text2text predict: the item strings differ from the CSR's labels")
        X, vec_s = best_time(lambda: model.preprocessor.predict(texts))
        preds, xlm_s = best_time(lambda: [x.predict(X, only_topk=max(T2T_TOPK, 10), beam_size=T2T_BEAM) for x in members])

        def ensemble():
            Q = ensemble_topk(model, preds, T2T_TOPK)
            return [[model.output_items[j] for j in Q.indices[s:e]] for s, e in zip(Q.indptr[:-1], Q.indptr[1:])]

        _, ens_s = best_time(ensemble)
        print(f"text2text predict [{smi}]: end to end (text in, items out) {len(texts) / e2e_s!r} QPS ({e2e_s!r} s, best "
              f"of 2); vectorize {vec_s!r} s, XLinearModel.predict x {len(members)} {xlm_s!r} s, ensemble and items "
              f"{ens_s!r} s (each best of 2)")

        folder = os.path.join(tmp, "model")
        model.save(folder)
        again = Text2Text.load(folder, device=device).predict(texts, ret_csr=True, **kw)
        a_labels, a_scores = ranked(again, T2T_TOPK)
        print(f"text2text save/load on the card: labels equal {np.array_equal(a_labels, labels)}, largest score diff "
              f"{float(np.abs(a_scores - scores).max())!r}")
        if not np.array_equal(a_labels, labels):
            raise RuntimeError("text2text: the model saved and loaded on the card predicts other items")
        # the port's CPU predict would run K1's plain version over rows padded
        # to the longest label's nonzeros, N x K x P x Qn compares a level:
        # too large here, so the CPU side is the plain sparse-product predict
        t0 = time.perf_counter()
        cpu_model = Text2Text.load(folder, device="cpu")
        X_cpu = cpu_model.preprocessor.predict(list(texts))
        plain = [plain_xlinear_predict(m, X_cpu, T2T_BEAM, max(T2T_TOPK, 10)) for m in cpu_model.xlinear_models]
        P_cpu = ensemble_topk(cpu_model, plain, T2T_TOPK)
        cpu_s = time.perf_counter() - t0
        c_labels, _ = ranked(P_cpu, T2T_TOPK)
        agree = float((c_labels == labels).mean())
        pads = [[tuple(l.parent_packed.shape) for l in m.model._get_compiled().layers if l.kind == "plabel"] for m in members]
        print(f"text2text CPU: loaded with device='cpu', {len(texts)} texts by the plain sparse-product predict in "
              f"{cpu_s!r} s: (row, rank) items equal to the card's {agree!r}; the card's padded plabel tables "
              f"(parents, children, 2P) {pads}")
        if agree < T2T_MIN_CPU_AGREE:
            raise RuntimeError(f"text2text CPU: agreement {agree!r} < {T2T_MIN_CPU_AGREE}")
        # the scores, not only the ranking: each member's on the card against
        # its plain predict (rank_average's ensembled scores are ranks)
        if (X_cpu != X).nnz:
            raise RuntimeError("text2text CPU: the loaded preprocessor vectorizes the test texts differently")
        for i, (got, want) in enumerate(zip(preds, plain)):
            check_scores(got, want, f"text2text scores member {i}, card against plain")
        k1_err = check_k1_text2text(members, cpu_model.xlinear_models, X)
    return launches, k1_err


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


def t2t_member_inputs(n_test):
    """One Text2Text member's inputs on phase 13b's data, as Text2Text.train
    makes them: (X, Y) of the train lines, X of the first ``n_test`` test
    lines, and the PIFA label embedding."""
    from pecos_tpu_torch.utils.featurization.text import Preprocessor
    from pecos_tpu_torch.xmc import LabelEmbeddingFactory

    corpus = load_script("tokenizer_bench").make_corpus(**T2T_CORPUS)
    with tempfile.TemporaryDirectory() as tmp:
        items, trn, tst = make_t2t_files(tmp, corpus)
        parsed = Preprocessor.load_data_from_file(trn, label_text_path=items)
        pre = Preprocessor.train(parsed["corpus"], vectorizer_config=T2T_VECTORIZER)
        X, Y = pre.predict(parsed["corpus"]), parsed["label_matrix"]
        Xt = pre.predict(Preprocessor.load_data_from_file(tst)["corpus"][:n_test])
    return X, Y, Xt, LabelEmbeddingFactory.create(Y, X, method="pifa")


# one process of ``--f8-cost``: argv tree, data folder, the solve's kwargs
# (JSON); the package is imported from the tree, every time on the card
F8_COST_RUN = """
import json, os, sys, time
tree, data, tight = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
sys.path.insert(0, tree)
import numpy as np, scipy.sparse as smat, torch
import pecos_tpu_torch
from pecos_tpu_torch.xmc import solvers
from pecos_tpu_torch.xmc.xlinear import XLinearModel
assert os.path.dirname(os.path.dirname(os.path.abspath(pecos_tpu_torch.__file__))) == os.path.abspath(tree)

def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0

f8 = np.load(os.path.join(data, "f8.npz"))
args = [torch.from_numpy(f8[k]).cuda() for k in ("ids", "vals", "y", "c")]
solve_s = [timed(lambda: solvers.solve_sparse_rows(*args, Db=int(f8["Db"]), **tight))[1] for _ in range(3)]
X, Y = (smat.load_npz(os.path.join(data, f"{k}.npz")) for k in ("X", "Y"))
C = [smat.load_npz(os.path.join(data, f"C{d}.npz")) for d in range(int(f8["depth"]))]
model, train_s = timed(lambda: XLinearModel.train(X, Y, C=C, device="cuda"))
nnz = [int(m.W.nnz) for m in model.model.model_chain]
print(json.dumps({"solve_s": solve_s, "train_s": train_s, "W_nnz": nnz}))
"""


def f8_cost(device, smi, parent):
    """``--f8-cost PARENT``: the F8 repair's cost.  solve_sparse_rows at
    F8_SOLVE (three solves on the card, the first one warm-up) and one
    Text2Text member's XLinearModel.train (phase 13b's data, seed 0's chain),
    each in a process of its own with the package of PARENT (a checkout of
    the commit before the repair) or of this checkout, in the order parent,
    change, change, parent."""
    import torch

    from pecos_tpu_torch.xmc import Indexer

    X, Y, _, feats = t2t_member_inputs(0)
    chain = list(Indexer.gen(feats, seed=0, device=device, **MR_INDEX))
    del feats
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as data:
        P, xcap, Db, ns = F8_SOLVE
        np.savez(os.path.join(data, "f8.npz"), **dict(zip(("ids", "vals", "y", "c"), f8_inputs())), Db=Db, depth=len(chain))
        for name, mat in (("X", X), ("Y", Y), *((f"C{d}", C) for d, C in enumerate(chain))):
            smat.save_npz(os.path.join(data, f"{name}.npz"), mat.tocsr() if name in ("X", "Y") else mat.tocsc())
        print(f"f8 cost: X {X.shape} nnz {X.nnz}, Y {Y.shape}, chain {[C.shape for C in chain]}; solve P {P} x (Db {Db} + 2)")
        for name, tree in (("parent", parent), ("change", HERE), ("change", HERE), ("parent", parent)):
            proc = subprocess.run([sys.executable, "-c", F8_COST_RUN, tree, data, json.dumps(TIGHT)],
                                  capture_output=True, text=True, timeout=900)
            if proc.returncode:
                raise RuntimeError(f"f8 cost {name}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
            r = json.loads(proc.stdout.strip().splitlines()[-1])
            print(f"f8 cost {name} [{smi}]: solve_sparse_rows chunked {r['solve_s']!r} s (the first warm-up); one "
                  f"member's XLinearModel.train {r['train_s']!r} s, W nnz {r['W_nnz']}")


def profile_text2text(device, smi, n_predict=2048):
    """``--profile-text2text``: cProfile over one Text2Text member's index and
    train (seed 0) on phase 13b's data, host functions by own and by
    cumulative time; then torch.profiler over that member's predict of
    ``n_predict`` test texts."""
    import cProfile
    import io
    import pstats

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pecos_tpu_torch.xmc import Indexer
    from pecos_tpu_torch.xmc.xlinear import XLinearModel

    X, Y, Xt, feats = t2t_member_inputs(n_predict)
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    chain = Indexer.gen(feats, seed=0, device=device, **MR_INDEX)
    model = XLinearModel.train(X, Y, C=chain, device=device)
    torch.cuda.synchronize()
    prof.disable()
    print(f"text2text member train profile [{smi}]: index and train {time.perf_counter() - t0!r} s on the host's clock")
    for key, top in (("tottime", 25), ("cumulative", 30)):
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats(key).print_stats(top)
        print("\n".join(l for l in out.getvalue().splitlines() if l.split() and (l.split()[0].replace("/", "").isdigit() or "ncalls" in l)))
    kw = dict(beam_size=T2T_BEAM, only_topk=T2T_TOPK)
    model.predict(Xt[:BATCH], **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        model.predict(Xt, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print_profile(p, wall, f"text2text member predict ({Xt.shape[0]} texts)", smi)


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
    if sys.argv[1:] == ["--profile-text2text"]:
        profile_text2text(device, smi)
        return 0
    if sys.argv[1:2] == ["--f8-cost"] and len(sys.argv) == 3:
        f8_cost(device, smi, os.path.abspath(sys.argv[2]))
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

    # 9. compiled folder, eager and lazy (phase 5's model stays on the card for phase 12b)
    eager_launches, lazy_launches = run_compiled(compiled, X, P, n_plabel, smi, kw, device)
    del compiled
    gc.collect()
    torch.cuda.empty_cache()

    # 10. training: solvers (F8: the chunked solve twice), the golden fixture, the matched-recall benchmark
    check_solvers(device, smi)
    check_f8_solve(device, smi)
    golden_launches = run_golden(device, smi)
    train_launches, mr = run_matched_recall(device, smi)
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
    del base
    gc.collect()
    torch.cuda.empty_cache()

    # 12. multi-device: the mesh's dry run, phase 5's predict sharded over lp, the dense engines, distributed train
    run_dryrun(smi)
    sharded_launches = run_sharded_predict(xlm, X, P, n_plabel, smi, kw)
    run_dense_engines(mr["model"], mr["data"][2], smi)
    run_dist_train(mr, smi, device)
    del xlm, mr
    gc.collect()
    torch.cuda.empty_cache()

    # 13. text2text: Tfidf at the tokenizer benchmark's protocol, then Text2Text trained and served on the card
    t2t_launches, t2t_k1_err = run_text2text(device, smi, run_tfidf())
    max_err = max(max_err, t2t_k1_err)

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
            "sharded_predict": sharded_launches, "text2text_predict": t2t_launches,
        },
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
