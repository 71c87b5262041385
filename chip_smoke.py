"""Smoke run of the PyTorch + CUDA port (pecos_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                      # phases 1-15, the result lines last
    python3 chip_smoke.py --ann-options        # phases 1-2, K1 at phase 15's shapes, then phase 15 on phase 11's data
    python3 chip_smoke.py --xtransformer       # phases 1-2, then phase 14 alone
    python3 chip_smoke.py --profile-xtransformer  # phases 1-2, then torch.profiler over one XR-Transformer level's train and a predict
    python3 chip_smoke.py --profile-text2text  # phases 1-2, then cProfile over one phase-13b member's train and torch.profiler over its predict
    python3 chip_smoke.py --profile-ann        # phases 1-2, then torch.profiler over phase 11's dense build and sparse predict, and phase 15c's build at 20,000 points
    python3 chip_smoke.py --profile-predict    # phases 1-2, then torch.profiler over phase 6's batch loop and one predict
    python3 chip_smoke.py --f8-cost PARENT     # phases 1-2, then the F8 solve and one phase-13b member's train under PARENT's package and this one's
    python3 chip_smoke.py --grouped-gemm       # phases 1-2, then the grouped GEMM against its plain version and timed at the expert layer's shapes, then the expert layer's fused kernels against the unfused sequence

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
             gather-dots shape, lazy selection with empty slots, the
             options' shapes of phase 15 (the exact rescore after a
             PQ-guided walk, the Alg-4 prune's distances and its lazy
             selection), a query above one hash table's capacity, an odd P,
             duplicate query ids, and the benchmark's wiki500k-batch levels
             (N 1,024 x K 620 and K 160 at P 512, queries of lognormal
             lengths padded to 4,096 slots, so most 512-slot chunks hold
             pads alone and the launch spreads a query over more blocks).
4. timing  — K1 by row id at the nine shapes of the main paths (predict,
             batch 1, HNSW gather-dots, lazy selection, rescore, prune
             distances, prune selection, wiki500k-batch's label level and
             level 3), the L2 flushed before each launch: kernel, plain
             version (where its compare block is small enough to time) and
             a torch.searchsorted composite, beside the bound (bytes over
             3.35 TB/s).
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
             with eager; peak memory below the same lazy predict's with
             every layer resident).
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
             the sparse product at the candidate columns; (c) PIFA's
             product Y^T X on (b)'s train data (90,000 x 8,192 labels,
             90,000 x 2.8M features) through the host core's SpGEMM on
             every host thread, twice (equal), and as scipy's one-threaded
             product: seconds of each, nnz, exact zeros kept, and equal
             values wherever both hold an entry.
14. xtransformer — (a) the five encoder families (bert, roberta, distilbert,
             xlm-roberta, xlnet) at their base widths, random-init from a
             seed, 8 x 128 tokens through the card and the CPU: pooled
             embeddings agree; (b) XTransformer.train at DistilBERT-base width
             on the first 20,000 train lines of 13b's files (X_feat a word
             1-2 gram Tfidf of them): three fine-tuned levels whose loss
             falls, the concat ranker (tfn) trained on [X_feat ||
             embeddings], which launches no K1 (0 launches); predict of the
             10,000 test texts through K1 at every plabel level, P@1 at least the
             TF-IDF-only XLinearModel's minus 0.02, K1 launches = plabel
             levels x batches, QPS split into tokenize / encode / concat /
             ranker; the saved folder on the CPU (>= 99.5% equal labels); K1 at
             the ranker's multi-chunk shapes against the float64 sparse
             product, and timed; (c) dist_fine_tune on a mesh of the card
             four times against one device (20 steps, dropout 0), moments
             split four ways; (d) RankingModel with LoRA (rank 8, q_lin /
             v_lin) on (test text, item) groups of 4: the loss falls, the
             base stays bit-equal, the saved folder scores alike on the CPU.
15. ann-options and fm — HNSW's two build options on phase 11's data (M=32,
             efC=100): (a) dense build_pq="true" (scan mode, S=64), recall@10
             >= 0.99 at efS=100, QPS at efS 50/100/200; (b) dense
             reverse_alg4=True (eager), recall@10 >= 0.99 at efS=100; (c)
             sparse reverse_alg4=True through K1, tie-aware recall@10 >= 0.99
             at efS=100; (d) sparse build_pq="true" (a 128-d count-sketch
             guide), tie-aware recall@10 >= 0.95 at efS=100; each build's
             seconds, peak memory and K1 launches (> 0 in (c) and (d)); (e)
             build (a) saved, loaded and searched again, ids equal; (f) the
             FM-for-XMC demo's settings trained on the card and on the CPU
             from one draw: held-out P@1 > 0.5, SIP error <= 1e-4, scores
             within FM_SCORE_RTOL of the CPU's.

Every K1 launch of a phase's run is counted with the count set to 0 just
before it.  The line before the last is a JSON object describing each kernel
of the path; the last line is {"ok": true, "device": {...}}.
"""

import copy
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
    (1<<30, value 0), as the HNSW graph's sparse rows are padded; with
    ``pad="lognormal"`` only the queries are padded, each past a length of
    lognormal_lengths'."""
    rng = np.random.default_rng(seed)
    qids = unique_rows(rng, N, Qn, D_feat)
    qvals = rng.standard_normal((N, Qn)).astype(np.float32)
    wi = unique_rows(rng, N * K, P, D_feat + 1).reshape(N, K, P)
    wv = rng.standard_normal((N, K, P)).astype(np.float32)
    if pad == "lognormal":
        qpad = np.arange(Qn)[None, :] >= lognormal_lengths(rng, N, Qn)[:, None]
        qids[qpad], qvals[qpad] = D_feat + 1, 0.0
    elif pad:
        qpad = np.arange(Qn)[None, :] >= (Qn - rng.integers(0, Qn // 2 + 1, size=N))[:, None]
        qids[qpad], qvals[qpad] = SPARSE_PAD_ID if pad == "hnsw" else D_feat + 1, 0.0
        wpad = np.arange(P)[None, None, :] >= (P - rng.integers(0, P // 2 + 1, size=(N, K)))[:, :, None]
        wi[wpad], wv[wpad] = SPARSE_PAD_ID if pad == "hnsw" else 0, 0.0
    return qids, qvals, np.concatenate([wi, wv.view(np.int32)], axis=-1)


# wiki500k-batch's query lengths (portbench/traffic/batch.json, its
# configuration's mean): lognormal, log-sigma 0.8, mean 387 nonzeros
WIKI_QUERY_NNZ, WIKI_QUERY_SIGMA = 387, 0.8


def lognormal_lengths(rng, n, hi, mean=WIKI_QUERY_NNZ, sigma=WIKI_QUERY_SIGMA):
    """``n`` query lengths in [1, hi]: the (i + 1/2) / n quantiles of a
    lognormal of this mean and log-sigma, in an order drawn from ``rng``
    (at n 1,024 and hi 4,096: 77% fit one 512-slot chunk, ~7 pass 2,048)."""
    z = np.array([statistics.NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    raw = np.exp(np.log(mean) - sigma * sigma / 2 + sigma * z)
    return rng.permutation(np.clip(np.rint(raw), 1, hi).astype(np.int64))


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
# phase 15's sparse HNSW shapes by row id, as K1_ROW_CASES: the exact rescore
# after a PQ-guided walk (2,048 queries x ceil(1.3 x efC) = 130 candidates),
# and the Alg-4 reverse prune's distances (a chunk of A_CHUNK = 21,845 rows x
# 128 candidates: 64 neighbors and 64 arrivals) and one step of its lazy
# selection (each row's candidate against the cap = 64 rows selected so far)
K1_OPTION_SHAPES = [
    ("hnsw rescore", 2048, 130, ANN_SPARSE_P, ANN_SPARSE_P, "perm", "hnsw", False, 100_000),
    ("hnsw prune dists", 21845, 128, ANN_SPARSE_P, ANN_SPARSE_P, "perm", "hnsw", False, 100_000),
    ("hnsw prune select", 21845, 64, ANN_SPARSE_P, ANN_SPARSE_P, "select", "hnsw", False, 100_000),
]
# wiki500k-batch's K1 levels above one chunk, as K1_ROW_CASES: the label
# level (labels dealt to leaf clusters by a permutation, so a query's
# candidates are scattered rows) and level 3 (level 2 is level 3's shape
# over 512 rows)
K1_WIKI_SHAPES = [
    ("wiki500k-batch label level by label rows", 1024, 620, 512, 4096, "perm", "lognormal", True, 501_070),
    ("wiki500k-batch level 3 by parent rows", 1024, 160, 512, 4096, "parents", "lognormal", True, 512 * NR_SPLITS),
]
# K1 by row id: (name, N, K, P, Qn, layout, pad, bias, table rows), as the
# callers pass rows, then a query above one table's capacity (512), an odd P
# and duplicate query ids, then wiki500k-batch's label level (501,070
# labels, rows of 511 features and the bias) and its level 3 (512 parents
# of 16), its queries padded to 4,096 past lognormal lengths.
# layout "parents": BEAM runs of K / BEAM consecutive rows, the children of
# BEAM random parents where labels are numbered by parent (phase 5's tree,
# wiki500k-batch's levels above the labels), some -1 and 5% of the rows
# zero; "perm": a random permutation of the table's rows; "select": the
# lazy selection's index into the HNSW corpus's rows, -1 past each row's
# count; "dups": random rows
K1_ROW_CASES = [
    ("predict by parent rows", 1024, 160, 64, 256, "parents", False, True, 4096 * NR_SPLITS),
    ("batch-1 by parent rows", 1, 160, 64, 256, "parents", False, True, 4096 * NR_SPLITS),
    ("hnsw gather-dots by id", 2048, 256, ANN_SPARSE_P, ANN_SPARSE_P, "perm", "hnsw", False, 2048 * 256),
    ("hnsw lazy-select by id", 2048, 32, ANN_SPARSE_P, ANN_SPARSE_P, "select", "hnsw", False, 100_000),
    *[(f"{name} by id", *shape) for name, *shape in K1_OPTION_SHAPES],
    ("above one table", 8, 37, 64, 5000, "perm", True, True, 8 * 37),
    ("odd P", 5, 7, 13, 600, "perm", True, True, 5 * 7),
    ("duplicate query ids", 64, 160, 64, 256, "dups", False, True, 20_000),
    *K1_WIKI_SHAPES,
]
# the timed shapes: (name, N, K, P, Qn, layout, pad, bias, table rows): the
# last plabel layer's packed rows (32,768 parents x 16 children), and the
# sparse HNSW corpus's 100,000 packed rows, by phase 11's and phase 15's callers
K1_TIMED = [
    ("predict", 1024, 160, 64, 256, "parents", False, True, (L // NR_SPLITS) * NR_SPLITS),
    ("batch-1", 1, 160, 64, 256, "parents", False, True, (L // NR_SPLITS) * NR_SPLITS),
    ("hnsw gather-dots", 2048, 256, ANN_SPARSE_P, ANN_SPARSE_P, "perm", "hnsw", False, 100_000),
    ("hnsw lazy-select", 2048, 32, ANN_SPARSE_P, ANN_SPARSE_P, "select", "hnsw", False, 100_000),
    *K1_OPTION_SHAPES,
    *K1_WIKI_SHAPES,
]
# query rows per call of K1's plain version at K 256, P 96: its (rows, K, P,
# 64) compare block stays under ~16 GB, and at other K x P as many elements
PLAIN_ROWS_CHUNK = 2048
# time_k1 times the plain version only where its compare elements (N x K x
# P x Qn) stay under this: ~0.1 s a call at most, not ~10 s
PLAIN_TIMED_ELEMENTS = 1 << 36
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
# phase 15: each option's build on phase 11's data, its recall@10 bar at efS=100:
# tests/test_hnsw.py's 0.99, and 0.95 for the sketch-guided sparse walk (the
# JAX package's TrainParams.build_pq docstring: it costs recall on sparse corpora)
# --profile-ann's sparse reverse_alg4 build: a trace of all 100,000 points
# did not finish within the script's time limit
ANN_ALG4_PROFILE_N = 20_000
ANN_OPT_BUILDS = {  # name -> (dense or sparse, train kwargs, efS values, recall bar)
    "dense build_pq": ("dense", dict(metric_type="l2", build_pq="true"), ANN_DENSE_EFS, 0.99),
    "dense reverse_alg4": ("dense", dict(metric_type="l2", reverse_alg4=True), (100,), 0.99),
    "sparse reverse_alg4": ("sparse", dict(metric_type="ip", data_type="csr", reverse_alg4=True), (100,), 0.99),
    "sparse build_pq": ("sparse", dict(metric_type="ip", data_type="csr", build_pq="true"), (100,), 0.95),
}
# 15f: the FM example's demo settings (examples/fm-for-xmc/fm.py:276-285); the
# card's held-out scores within FM_SCORE_RTOL x the largest of the CPU's
FM_DEMO = dict(k=8, epochs=30, l2=2e-5, lr=0.2, batch_size=256, neg_per_pos=8)
FM_N_VAL, FM_MIN_P1, FM_SIP_ATOL, FM_SCORE_RTOL = 64, 0.5, 1e-4, 1e-4
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
# phase 14: each encoder family at its base widths (the published config.json
# of bert-base-uncased, roberta-base, distilbert-base-uncased,
# xlm-roberta-base and xlnet-base-cased), random-init from SEED
_BERT_BASE = dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072)
_ROBERTA_BASE = dict(_BERT_BASE, max_position_embeddings=514, type_vocab_size=1, layer_norm_eps=1e-5, pad_token_id=1,
                     bos_token_id=0, eos_token_id=2)
XTF_DISTILBERT = dict(vocab_size=30_522, dim=768, n_layers=6, n_heads=12, hidden_dim=3072, max_position_embeddings=512,
                      dropout=0.1, attention_dropout=0.1)
XTF_FAMILIES = {
    "bert": dict(_BERT_BASE, vocab_size=30_522, max_position_embeddings=512),
    "roberta": dict(_ROBERTA_BASE, vocab_size=50_265),
    "distilbert": XTF_DISTILBERT,
    "xlm-roberta": dict(_ROBERTA_BASE, vocab_size=250_002),
    "xlnet": dict(vocab_size=32_000, d_model=768, n_layer=12, n_head=12, d_inner=3072, ff_activation="gelu"),
}
XTF_FORWARD = (8, 128)  # texts x tokens of 14a's forward
# pooled embeddings, card against the CPU (float32 both, sums in another order)
XTF_ENC_ATOL, XTF_ENC_RTOL = 1e-4, 1e-3
# 14b: the first XTF_N_TRN of phase 13b's train lines (a depth cut from
# 90,000), every test line; the matcher at DistilBERT-base width, three levels
# of XTF_MATCHER["max_steps"] steps; the ranker with XR-Transformer's default
# (tfn) negatives, beam and top-k as phase 13b's
XTF_N_TRN = 20_000
XTF_MATCHER = dict(model_type="distilbert", truncate_length=128, batch_size=32, bootstrap_method="inherit",
                   max_steps=100, learning_rate=1e-4, seed=SEED)
XTF_RANKER = dict(negative_sampling_scheme="tfn", beam_size=T2T_BEAM, only_topk=T2T_TOPK)
XTF_P1_MARGIN = 0.02  # test P@1 at least the TF-IDF-only XLinearModel's minus this
XTF_CPU_TEXTS, XTF_MIN_CPU_AGREE = 256, 0.995
# 14c: dist_fine_tune on a mesh of 4 slots against one device, dropout 0;
# ||mesh - one|| within XTF_DIST_REL of ||one - initial||
XTF_DIST_DEVICES, XTF_DIST_STEPS, XTF_DIST_TEXTS, XTF_DIST_REL = 4, 20, 4096, 1e-3
# 14d: the reranker's pairs (RR_QUERIES test texts, 4 items each) and train
RR_QUERIES, RR_PREDICT_PAIRS, RR_CPU_PAIRS = 1000, 4000, 64
RR_TRAIN = dict(model_type="distilbert", truncate_length=128, batch_size=16, learning_rate=1e-3, max_steps=200,
                loss_fn="pointwise", group_size=4, lora_rank=8, lora_targets=("q_lin", "v_lin"), seed=SEED)
RR_ATOL = 1e-4  # scores of the saved folder on the CPU (LoRA merged) against the card's


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
    ``layout`` sets the index as K1_ROW_CASES and K1_OPTION_SHAPES say."""
    import torch

    D_feat = 4 * Qn
    qids, qvals, _ = make_k1_case(N, 1, 8, Qn, D_feat, pad, seed)
    if layout == "dups":  # every other nonzero repeats its neighbour's id, with its own value
        qids[:, 1::2] = qids[:, 0::2]
    gen = torch.Generator(device).manual_seed(seed)
    ids = torch.randint(0, D_feat + 1, (R, P), generator=gen, device=device, dtype=torch.int32)
    vals = torch.randn((R, P), generator=gen, device=device)
    if pad and pad != "lognormal":
        tail = torch.randint(0, P // 2 + 1, (R, 1), generator=gen, device=device)
        empty = torch.arange(P, device=device)[None, :] >= P - tail
        ids[empty], vals[empty] = SPARSE_PAD_ID if pad == "hnsw" else 0, 0.0
    if layout == "parents":  # labels with no weights: zero rows
        gone = torch.rand((R,), generator=gen, device=device) < 0.05
        ids[gone], vals[gone] = 0, 0.0
    table = torch.cat([ids, vals.view(torch.int32)], dim=1)
    if layout == "parents":
        kids = K // BEAM
        parents = torch.randint(0, R // kids, (N, BEAM), generator=gen, device=device)
        rows = (parents[:, :, None] * kids + torch.arange(kids, device=device)).reshape(N, K)
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


def plain_rows(qids, qvals, table, rows, *bias_args):
    """K1's plain version by row id, PLAIN_ROWS_CHUNK query rows a call at
    K x P = 256 x 96, fewer at wider K x P (each row's scores depend on its
    row alone)."""
    import torch

    from pecos_tpu_torch.ops.intersect import intersect_scores_rows_reference

    C = max(1, PLAIN_ROWS_CHUNK * 256 * ANN_SPARSE_P // (rows.shape[1] * (table.shape[1] // 2)))
    return torch.cat([intersect_scores_rows_reference(qids[s : s + C], qvals[s : s + C], table, rows[s : s + C], *bias_args)
                      for s in range(0, qids.shape[0], C)])


def check_k1_rows(device, cases=K1_ROW_CASES):
    """intersect_scores_rows vs its plain version on ``device`` for every
    by-id case; returns the max abs error.  Tolerance as check_k1's (the order
    of the final P-sum and of duplicate ids' sum differ)."""
    import torch

    from pecos_tpu_torch.ops.intersect import intersect_scores_rows

    worst = 0.0
    for name, N, K, P, Qn, layout, pad, bias, R in cases:
        q, v, table, rows, bias_args = make_rows_case(device, N, K, P, Qn, layout, pad, bias, R, seed=N + K + Qn)
        got = intersect_scores_rows(q, v, table, rows, *bias_args)
        want = plain_rows(q, v, table, rows, *bias_args)
        t_abs = torch.cat([table[:, :P], table[:, P:].view(torch.float32).abs().view(torch.int32)], dim=1)
        scale = plain_rows(q, v.abs(), t_abs, rows, *bias_args).max().item()
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


def k1_bound(v, table, rows, P):
    """(bound ms, "bytes" or "operations", bytes) of one K1 call on these
    inputs, counting what the data needs: the real slots (value not 0, so
    no pad) of each distinct table row read, the row index, the real query
    nonzeros and the output, over the HBM rate; a multiply-add for each real
    slot of every row read (rows not -1), over the float32 rate."""
    import torch

    real = (table[:, P:].view(torch.float32) != 0).sum(dim=1)
    used = rows[rows >= 0]
    n_bytes = int(real[used.unique()].sum()) * 8 + rows.numel() * 8 + int((v != 0).sum()) * 8 + rows.numel() * 4
    ops = 2 * int(real[used].sum())
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), n_bytes


def time_k1(device, name, N, K, P, Qn, layout, pad, bias, R, iters):
    """K1 by row id at one of the K1_TIMED shapes: median ms of the kernel,
    the plain version (None above PLAIN_TIMED_ELEMENTS) and the searchsorted
    composite, in turns, each launch timed with CUDA events after a write of
    L2_FLUSH_BYTES, all queued behind a sleep of the card; with the bound.
    The composite is checked against the plain version, or where that is not
    timed against the kernel (which check_k1_rows holds to the plain version
    at these shapes)."""
    import torch

    from pecos_tpu_torch.ops.intersect import intersect_scores_rows

    q, v, table, rows, bias_args = make_rows_case(device, N, K, P, Qn, layout, pad, bias, R, seed=1)
    fns = {
        "kernel": lambda: intersect_scores_rows(q, v, table, rows, *bias_args),
        "plain": lambda: plain_rows(q, v, table, rows, *bias_args),
        "composite": lambda: k1_composite(q, v, table, rows, *bias_args),
    }
    if N * K * P * Qn > PLAIN_TIMED_ELEMENTS:
        del fns["plain"]
    outs = {key: fn() for key, fn in fns.items()}  # warm
    ref = outs.get("plain", outs["kernel"])
    err = (outs["composite"] - ref).abs().max().item()
    if not err <= 1e-4 * max(ref.abs().max().item(), 1.0):
        what = "plain version" if "plain" in fns else "kernel"
        raise RuntimeError(f"K1 timing {name}: the composite differs from the {what} by {err!r}")
    del outs, ref
    ms = time_calls(device, fns, iters)
    bound_ms, bound_by, n_bytes = k1_bound(v, table, rows, P)
    return {
        "N": N, "K": K, "P": P, "Qn": Qn, "table_rows": R, "ms": ms["kernel"], "plain_ms": ms.get("plain"),
        "composite_ms": ms["composite"], "bound_ms": bound_ms, "bound_by": bound_by, "bytes": n_bytes,
        "share": bound_ms / ms["kernel"],
    }


# the grouped GEMM at Moonlight-16B-A3B's expert layer: 256 texts of 128 slots, top-6 of 64 experts,
# ~7% of the slots pads (their pairs past the last group); gate-up (N 2,816, K 2,048) and down (N 2,048, K 1,408)
GG_SHAPES = (("gate_up", 2816, 2048), ("down", 2048, 1408))
GG_PAIRS, GG_EXPERTS, GG_PAD_SHARE = 256 * 128 * 6, 64, 0.07
GG_SOURCE = "pecos_tpu_torch/ops/csrc/grouped_gemm.cu"
BF16_FLOP_PER_S, HBM_BYTES_PER_S = 9.894e14, 3.35e12  # H100 SXM data sheet, 700 W
# the expert layer's main-path launches, by the row run_expert_kernels times them in: the kernel's
# entry, its source and the unfused sequence it replaces (the store mode runs in tests and here only)
EXPERT_KERNELS = {
    "gate_up": ("grouped_gemm_swiglu", GG_SOURCE,
                "grouped_gemm store mode writing h (pairs x 2I), then F.silu(h[:, :I]) * h[:, I:]"),
    "down": ("grouped_gemm_scatter", GG_SOURCE, "grouped_gemm store mode, then pairs[order] = y (index_put)"),
    "combine": ("expert_combine", "pecos_tpu_torch/ops/csrc/expert_combine.cu",
                "pairs.float(), torch.bmm with the gates, where(keep), .to(bfloat16), + shared experts"),
}


def run_grouped_gemm(device, smi):
    """The grouped GEMM kernel against its plain version (a matmul a group)
    at the expert layer's shapes, with groups as uneven as a router under a
    calibrated bias leaves them (busiest ~1.3x the mean) and one empty; then
    kernel, plain and ``torch._grouped_mm`` (the library yardstick, which the
    port never calls) timed with the L2 flushed, beside the bound (the larger
    of operations at the bfloat16 peak and bytes at the HBM peak)."""
    import torch

    from pecos_tpu_torch.ops.grouped_gemm import grouped_gemm, grouped_gemm_reference

    rng = np.random.default_rng(SEED)
    real = int(GG_PAIRS * (1 - GG_PAD_SHARE))
    share = rng.uniform(0.7, 1.3, GG_EXPERTS)
    share[7] = 0.0
    counts = np.floor(share / share.sum() * real).astype(np.int64)
    counts[0] += real - counts.sum()
    bounds = np.concatenate([[0], np.cumsum(counts)])
    offsets = torch.from_numpy(bounds).to(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    out = []
    for what, N, K in GG_SHAPES:
        a = torch.randn((GG_PAIRS, K), generator=gen, device=device).to(torch.bfloat16)
        w = (0.02 * torch.randn((GG_EXPERTS, N, K), generator=gen, device=device)).to(torch.bfloat16)
        got = grouped_gemm(a, w, offsets)[:real].float()
        plain = grouped_gemm_reference(a, w, offsets)[:real].float()
        scale = plain.abs().mean().item()
        err = float(((got - plain).abs() / (plain.abs() + scale)).max())
        if err > 2.0**-7:  # the two round the same float32 sums to bfloat16: a unit of the 8th bit apart at most
            raise RuntimeError(f"grouped GEMM {what}: kernel against plain {err!r}")

        def plain_fn(a=a, w=w):
            o = torch.zeros((a.shape[0], w.shape[1]), dtype=a.dtype, device=device)
            for e in range(GG_EXPERTS):
                if counts[e]:
                    o[bounds[e] : bounds[e + 1]] = a[bounds[e] : bounds[e + 1]] @ w[e].T
            return o

        fns = {"kernel": lambda a=a, w=w: grouped_gemm(a, w, offsets), "plain": plain_fn}
        library_error = None
        try:
            ends = offsets[1:].to(torch.int32)
            lib = torch._grouped_mm(a, w.transpose(1, 2), offs=ends)[:real].float()
            if float(((lib - plain).abs() / (plain.abs() + scale)).max()) > 2.0**-7:
                raise RuntimeError("torch._grouped_mm disagrees with the plain version")
            fns["library"] = lambda a=a, w=w: torch._grouped_mm(a, w.transpose(1, 2), offs=ends)
        except (RuntimeError, AttributeError, TypeError) as e:
            library_error = repr(e)[:200]
        ms = time_calls(device, fns, 10)
        ops = 2.0 * real * N * K
        n_bytes = 2 * (real * K + GG_EXPERTS * N * K + real * N)
        bound_ms = 1e3 * max(ops / BF16_FLOP_PER_S, n_bytes / HBM_BYTES_PER_S)
        row = {"shape": what, "M": GG_PAIRS, "pairs": real, "N": N, "K": K, "experts": GG_EXPERTS,
               "busiest": int(counts.max()), "ms": ms["kernel"], "plain_ms": ms["plain"],
               "library_ms": ms.get("library"), "library_error": library_error, "bound_ms": bound_ms,
               "bound_by": "operations" if ops / BF16_FLOP_PER_S >= n_bytes / HBM_BYTES_PER_S else "bytes",
               "share": bound_ms / ms["kernel"], "tflop_per_s": ops / ms["kernel"] / 1e9, "max_err": err}
        print(f"grouped GEMM {what} [{smi}]: {json.dumps(row)}")
        out.append(row)
        del a, w
        torch.cuda.empty_cache()
    checks, fused = run_expert_kernels(device, smi)
    kernels = [{"name": "grouped_gemm", "route": "cuda", "source": GG_SOURCE, "replaces": None, "main_path": False,
                "shapes": out}]
    for row in fused:
        name, source, replaces = EXPERT_KERNELS[row["launch"]]
        ms = row["ms"]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces, "main_path": True,
                        "ms": ms["kernel"], "plain_ms": ms.get("plain", ms["unfused"]), "unfused_ms": ms["unfused"],
                        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "share": row["share"],
                        **({"gather_ms": ms["gather"], "with_gather_ms": ms["fused"]} if "gather" in ms else {})})
    print(json.dumps({"kernels": kernels, "expert_checks": checks}))
    return out


def ulps_apart(a, b):
    """Units in the last place of bfloat16 between a and b, elementwise (+0 and -0 are 0 apart)."""
    import torch

    def ordered(x):
        bits = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return (ordered(a) - ordered(b)).abs()


def expert_layer_case(device, seed=SEED, tokens=256 * 128, hidden=2048, width=1408, experts=GG_EXPERTS, k=6,
                      pad_share=GG_PAD_SHARE):
    """One expert layer forward's operands at Moonlight-16B-A3B's widths:
    tokens x, keep (the last ~7% of slots pads), each token's k experts
    (distinct, uneven over experts) and float32 gates, the pairs sorted by
    expert as the layer sorts them (pads' past the last group), the offsets,
    the weights and the shared experts' output."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((tokens, hidden), generator=gen, device=device).to(torch.bfloat16)
    keep = torch.rand(tokens, generator=gen, device=device) >= pad_share
    skew = torch.linspace(0.0, 0.6, experts, device=device)
    chosen = (torch.rand((tokens, experts), generator=gen, device=device) + skew).topk(k, dim=1).indices
    gates = torch.rand((tokens, k), generator=gen, device=device) * 0.5
    flat = torch.where(keep[:, None].expand(tokens, k).reshape(-1), chosen.reshape(-1), experts)
    sorted_experts, order = torch.sort(flat, stable=True)
    offsets = torch.searchsorted(sorted_experts, torch.arange(experts + 1, device=device))
    gate_up = (0.02 * torch.randn((experts, 2 * width, hidden), generator=gen, device=device)).to(torch.bfloat16)
    down = (0.02 * torch.randn((experts, hidden, width), generator=gen, device=device)).to(torch.bfloat16)
    shared = (0.1 * torch.randn((tokens, hidden), generator=gen, device=device)).to(torch.bfloat16)
    return dict(x=x, keep=keep, gates=gates, order=order, rows=order // k, offsets=offsets, gate_up=gate_up,
                down=down, shared=shared, k=k)


def run_expert_kernels(device, smi):
    """The expert layer's fused kernels at one forward of the Moonlight
    cell (256 texts of 128 slots): the SwiGLU gate-up GEMM over the gathered
    token rows, the down GEMM storing in token slots and the combine, each
    checked against the unfused sequence it replaces (PyTorch's gather, the
    plain grouped GEMM kernel, then SiLU, product, index_put, float32 bmm,
    where, cast and add): act and the rows bit-equal, the combine within a
    unit of bfloat16's last place.  Then each timed with the L2 flushed,
    beside its bound, its plain version and that unfused sequence; the
    gate-up launch alone (``kernel``), the gather, and the two together
    (``fused``)."""
    import torch
    import torch.nn.functional as F

    from pecos_tpu_torch.ops import expert_combine as ec
    from pecos_tpu_torch.ops import grouped_gemm as gg

    c = expert_layer_case(device)
    x, keep, gates, order, rows, offsets = c["x"], c["keep"], c["gates"], c["order"], c["rows"], c["offsets"]
    gate_up, down, shared, k = c["gate_up"], c["down"], c["shared"], c["k"]
    T, H = x.shape
    I = down.shape[2]
    real = int(offsets[-1])
    kept = keep[:, None].expand(T, k).reshape(-1)

    def unfused_gate_up():
        h = gg.grouped_gemm(x[rows], gate_up, offsets)
        return F.silu(h[:, :I]) * h[:, I:]

    def fused_gate_up():
        return gg.grouped_gemm_swiglu(x[rows], gate_up, offsets)

    def unfused_down(a):
        y = gg.grouped_gemm(a, down, offsets)
        pairs = torch.empty_like(y)
        pairs[order] = y
        return pairs

    want_act = unfused_gate_up()
    act = fused_gate_up()
    want_pairs = unfused_down(want_act)
    pairs = gg.grouped_gemm_scatter(act, down, offsets, order)
    want_out = ec.expert_combine_reference(want_pairs, gates, keep, shared)
    out = ec.expert_combine(pairs, gates, keep, shared)
    plain_act = gg.grouped_gemm_swiglu_reference(x[rows], gate_up, offsets)
    torch.cuda.synchronize()
    checks = {
        "pairs": real, "tokens": T, "kept_tokens": int(keep.sum()),
        "act_bit_equal": bool(torch.equal(act[:real], want_act[:real])),
        "rows_bit_equal": bool(torch.equal(pairs[kept], want_pairs[kept])),
        "combine_max_ulps": int(ulps_apart(out, want_out).max()),
        "combine_share_differing": float((out != want_out).float().mean()),
        # the plain version rounds cuBLAS's float32 sums: a unit of bfloat16's 8th bit apart at most, then SiLU
        "act_plain_max_rel": float(((act[:real].float() - plain_act[:real].float()).abs()
                                    / (plain_act[:real].float().abs() + plain_act[:real].float().abs().mean())).max()),
    }
    print(f"expert kernels check [{smi}]: {json.dumps(checks)}")
    if not (checks["act_bit_equal"] and checks["rows_bit_equal"]
            and checks["combine_max_ulps"] <= 1 and checks["act_plain_max_rel"] <= 2.0**-6):
        raise RuntimeError(f"expert kernels disagree with the unfused sequence: {checks}")
    del want_act, want_pairs, want_out, plain_act
    torch.cuda.empty_cache()

    xg = x[rows]
    host_offsets = offsets.cpu()  # the plain versions read the offsets on the host: no wait inside a timed launch
    ops_up, ops_down = 2.0 * real * 2 * I * H, 2.0 * real * H * I
    bytes_up = 2 * (real * H + c["gate_up"].numel() + real * I)
    bytes_down = 2 * (real * I + down.numel() + real * H)
    bytes_combine = 2 * real * H + 4 * gates.numel() + T + 2 * 2 * T * H
    timed = {
        "gate_up": ({"kernel": lambda: gg.grouped_gemm_swiglu(xg, gate_up, offsets),
                     "gather": lambda: x[rows],
                     "fused": fused_gate_up,
                     "unfused": unfused_gate_up,
                     "plain": lambda: gg.grouped_gemm_swiglu_reference(xg, gate_up, host_offsets)},
                    ops_up, bytes_up),
        "down": ({"kernel": lambda: gg.grouped_gemm_scatter(act, down, offsets, order),
                  "unfused": lambda: unfused_down(act),
                  "plain": lambda: gg.grouped_gemm_scatter_reference(act, down, host_offsets, order)},
                 ops_down, bytes_down),
        "combine": ({"kernel": lambda: ec.expert_combine(pairs, gates, keep, shared),
                     "unfused": lambda: ec.expert_combine_reference(pairs, gates, keep, shared)},
                    2.0 * real * H, bytes_combine),
    }
    rows_out = []
    for what, (fns, ops, n_bytes) in timed.items():
        ms = time_calls(device, fns, 10)
        t_ops, t_bytes = ops / BF16_FLOP_PER_S, n_bytes / HBM_BYTES_PER_S
        bound_ms = 1e3 * max(t_ops, t_bytes)
        row = {"launch": what, "ms": ms, "bound_ms": bound_ms, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "share": bound_ms / ms["kernel"], "ops": ops, "bytes": n_bytes}
        print(f"expert kernels {what} [{smi}]: {json.dumps(row)}")
        rows_out.append(row)
        torch.cuda.empty_cache()
    return checks, rows_out


def time_calls(device, fns, iters):
    """Median ms of each callable of ``fns``, called in turns (the order
    reversed every other round), each launch timed with CUDA events after a
    write of L2_FLUSH_BYTES, all queued behind a sleep of the card so that no
    event interval holds host time (each wrapper's Python and ctypes
    overhead)."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=device)
    events = {key: [] for key in fns}
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
    return {key: statistics.median(s.elapsed_time(e) for s, e in ev) for key, ev in events.items()}


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
    from pecos_tpu_torch.xmc.inference import load_compiled_layers, save_compiled_layers

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
        del lazy
        gc.collect()
        # the same lazy predict with every layer resident: the same code and
        # intermediates, every layer held at once
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        load_compiled_layers(folder, lazy=True, resident_budget_bytes=file_bytes, device=device).predict(Xq, **kw)
        resident_peak = torch.cuda.max_memory_allocated() - base
    check_agreement(*ranked(P_lazy, TOPK), e_labels, e_scores, f"compiled lazy: label agreement with eager on {N_COMPILED} queries")
    x_bytes = N_COMPILED * (D + 1) * 4
    print(f"compiled [{smi}]: save {save_s!r} s ({file_bytes} bytes on disk), eager load {load_s!r} s, "
          f"lazy open {lazy_load_s!r} s")
    print(f"compiled [{smi}]: lazy predict of {N_COMPILED} queries {lazy_s!r} s, every layer streamed; peak device "
          f"memory above the start {lazy_peak} bytes = query block {x_bytes} + {lazy_peak - x_bytes}, with every layer "
          f"resident {resident_peak} bytes (the eager model's layers: {layer_bytes} bytes); K1 launches eager "
          f"{eager_launches}, lazy {lazy_launches}")
    if lazy_peak >= resident_peak:
        raise RuntimeError(f"compiled lazy: streamed peak {lazy_peak} >= the peak with every layer resident {resident_peak}")
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


def ann_dense_data(device):
    """Phase 11a's data: (base, queries, exact top-10 ids, seconds)."""
    t0 = time.perf_counter()
    base, queries = load_script("ann_bench_data").make_data(**ANN_DENSE_DATA)
    true_ids = exact_topk_l2(base, queries, ANN_TOPK, device)
    return base, queries, true_ids, time.perf_counter() - t0


def ann_sparse_data():
    """Phase 11c's data, rows with sorted ids: (X, Q, ground-truth ids,
    ground-truth distances, seconds)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="pecos_sparse_ann_") as folder:
        load_script("sparse_hnsw_bench").gen(folder, **ANN_SPARSE_DATA)
        X, Q = (smat.load_npz(os.path.join(folder, f"sparse_{w}.npz")).tocsr() for w in ("base", "queries"))
        gt_i, gt_d = (np.load(os.path.join(folder, f"sparse_gt_{w}.npy")) for w in ("i", "d"))
    X.sort_indices()
    Q.sort_indices()
    return X, Q, gt_i, gt_d, time.perf_counter() - t0


def run_ann_dense(device, smi):
    """Phase 11a: synthetic SIFT at 100K, built and searched on the card;
    returns (model, base, queries, true top-10, numbers)."""
    import torch

    from pecos_tpu_torch.ann import HNSW
    from pecos_tpu_torch.ann.hnsw.graph import read_flag

    base, queries, true_ids, data_s = ann_dense_data(device)
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
    through K1; returns (K1 launches of the build, of the efS=100 predict,
    numbers, (X, Q, ground-truth ids, ground-truth distances))."""
    import torch

    from pecos_tpu_torch.ann import HNSW
    from pecos_tpu_torch.ann.hnsw.graph import read_flag
    from pecos_tpu_torch.ops.intersect import intersect_scores

    X, Q, gt_i, gt_d, data_s = ann_sparse_data()
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
    return build_launches, predict_launches, numbers, (X, Q, gt_i, gt_d)


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
    shard_bytes = [sum(l.nbytes for l in layers) for layers in mesh_layers(compiled, mesh, "labels")[0]]
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


def check_k1_text2text(members, host_members, X, n=T2T_K1_QUERIES, what="text2text"):
    """K1 at phase 13b's shapes: the first ``n`` rows of ``X`` scored at every
    plabel level of each member by the path's call (K1 by candidate id on
    the layer's ``packed`` rows), over the children of the beam parents the
    plain predict chose for them, against the sparse product X @ W at the
    candidate columns in float64 (0 where a parent has no such child);
    ``host_members`` hold the same weights as host matrices.  Tolerance as check_k1's.  Returns the max
    abs error."""
    import torch

    from pecos_tpu_torch.ops.intersect import intersect_scores_rows
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
            cand = padded_children(m.C)[0][parents].reshape(n, -1).astype(np.int64)
            got = intersect_scores_rows(
                q, v, layer.packed, torch.from_numpy(cand).to(dev), D if bias > 0 else None, bias
            ).cpu().numpy()
            cols, W = np.clip(cand, 0, None), m.W.tocsc().astype(np.float64)
            want = np.where(cand >= 0, np.take_along_axis((Xb @ W).toarray(), cols, axis=1), 0.0)
            scale = float(np.take_along_axis((abs(Xb) @ abs(W)).toarray(), cols, axis=1).max())
            err = np.abs(got - want)
            bad = int((err > 1e-5 * np.abs(want) + 1e-6 * scale).sum())
            print(f"K1 {what} member {i} level {d}: N={n} K={cand.shape[1]} table {tuple(layer.packed.shape)} "
                  f"({layer.packed.numel()} int32), Qn={q.shape[1]}: max_abs_err={float(err.max())!r} "
                  f"scale={scale!r} bad={bad}")
            if bad or not np.isfinite(got).all():
                raise RuntimeError(f"K1 {what} member {i} level {d}: {bad} scores outside tolerance")
            worst = max(worst, float(err.max()))
    return worst


class CallTimes:
    """Seconds of each call of the classmethod ``cls.name`` while active,
    the card synchronized before the clock stops; with ``keep``, also
    keep(result) of each call in ``kept``."""

    def __init__(self, cls, name, keep=None):
        self.cls, self.name, self.seconds, self.keep, self.kept = cls, name, [], keep, []

    def __enter__(self):
        self._orig = self.cls.__dict__[self.name]
        fn = self._orig.__func__

        def timed(klass, *args, **kwargs):
            t0 = time.perf_counter()
            out = fn(klass, *args, **kwargs)
            sync()
            self.seconds.append(time.perf_counter() - t0)
            if self.keep is not None:
                self.kept.append(self.keep(out))
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
        pads = [[tuple(l.packed.shape) for l in m.model._get_compiled().layers if l.kind == "plabel"] for m in members]
        print(f"text2text CPU: loaded with device='cpu', {len(texts)} texts by the plain sparse-product predict in "
              f"{cpu_s!r} s: (row, rank) items equal to the card's {agree!r}; the card's plabel tables "
              f"(labels, 2P) {pads}")
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
    data), one sparse predict at efS=100 (phase 11c's) and one sparse
    ``reverse_alg4`` build (phase 15c's) on the first ANN_ALG4_PROFILE_N
    rows."""
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
    del prof, model
    kw = ANN_OPT_BUILDS["sparse reverse_alg4"][1]
    Xc = X[:ANN_ALG4_PROFILE_N]
    Xc.sort_indices()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        HNSW.train(Xc, device=device, **ANN_BUILD, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print_profile(prof, wall, f"ann sparse build {kw}, {Xc.shape[0]} points", smi)


def t2t_data(corpus, n_test):
    """Phase 13b's data as Text2Text.train makes it: (X, Y) of the train
    lines and X of the first ``n_test`` test lines (None for 0)."""
    from pecos_tpu_torch.utils.featurization.text import Preprocessor

    with tempfile.TemporaryDirectory() as tmp:
        items, trn, tst = make_t2t_files(tmp, corpus)
        parsed = Preprocessor.load_data_from_file(trn, label_text_path=items)
        pre = Preprocessor.train(parsed["corpus"], vectorizer_config=T2T_VECTORIZER)
        X, Y = pre.predict(parsed["corpus"]), parsed["label_matrix"]
        Xt = pre.predict(Preprocessor.load_data_from_file(tst)["corpus"][:n_test]) if n_test else None
    return X, Y, Xt


def t2t_member_inputs(n_test):
    """One Text2Text member's inputs on phase 13b's data: t2t_data's (X, Y,
    Xt) and the PIFA label embedding."""
    from pecos_tpu_torch.xmc import LabelEmbeddingFactory

    X, Y, Xt = t2t_data(load_script("tokenizer_bench").make_corpus(**T2T_CORPUS), n_test)
    return X, Y, Xt, LabelEmbeddingFactory.create(Y, X, method="pifa")


def run_spgemm(smi, corpus):
    """Phase 13c: PIFA's product Z = Y^T X on phase 13b's train data, through
    the host core's SpGEMM (twice: one input must give one Z) and as scipy's
    product.  scipy drops the sums that are exactly 0; on every other entry
    the two must be equal."""
    from pecos_tpu_torch.utils.spgemm_util import spgemm_atb

    t0 = time.perf_counter()
    X, Y, _ = t2t_data(corpus, 0)
    data_s = time.perf_counter() - t0
    Z, native_s = best_time(lambda: spgemm_atb(Y, X), 1)
    again, again_s = best_time(lambda: spgemm_atb(Y, X), 1)
    S, scipy_s = best_time(lambda: Y.T.tocsr() @ X, 1)
    S = S.tocsr()
    S.sort_indices()
    zeros = int((Z.data == 0).sum())
    kept = Z.copy()
    kept.eliminate_zeros()
    same = all(np.array_equal(a, b) for a, b in ((again.indptr, Z.indptr), (again.indices, Z.indices), (again.data, Z.data)))
    equal = (S.shape == kept.shape and np.array_equal(S.indptr, kept.indptr) and np.array_equal(S.indices, kept.indices)
             and np.array_equal(S.data, kept.data))
    print(f"spgemm [{smi}]: Z = Y^T X of Y {Y.shape} ({Y.dtype}, nnz {Y.nnz}) and X {X.shape} ({X.dtype}, nnz {X.nnz}); "
          f"native spgemm_atb on {os.cpu_count()} host threads {native_s!r} s and again {again_s!r} s (equal "
          f"{same}), scipy Y.T.tocsr() @ X {scipy_s!r} s ({S.dtype}); nnz {Z.nnz} native, {S.nnz} scipy, {zeros} exact "
          f"zeros kept; equal wherever both hold an entry {equal}; data made in {data_s!r} s")
    if not same:
        raise RuntimeError("spgemm: two native products of the same operands differ")
    if not equal or Z.dtype != np.float32:
        raise RuntimeError("spgemm: the native product and scipy's differ on the entries both hold")


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


# ---------------------------------------------------------------------------
# phase 14: XR-Transformer and the XMR reranker
# ---------------------------------------------------------------------------


def sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def peak_reset():
    """Synchronize and restart the peak count; returns the bytes held now."""
    import torch

    if not torch.cuda.is_available():
        return 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peak_bytes():
    import torch

    return torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0


def write_vocab(folder, texts, size):
    """A WordPiece vocab.txt of ``size`` entries: the five specials, then the
    words of ``texts`` by falling count (ties by the word), then
    ``[unused{i}]`` entries if the texts hold fewer words."""
    from collections import Counter

    counts = Counter(w for t in texts for w in t.split())
    words = [w for w, _ in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))][: size - 5]
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words
    vocab += [f"[unused{i}]" for i in range(size - len(vocab))]
    path = os.path.join(folder, "vocab.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    return path


def run_encoder_families(device, smi, families=None):
    """Phase 14a: each encoder family at its base widths, random-init on the
    CPU from SEED, copied to ``device``; XTF_FORWARD random token ids through
    both, pooled embeddings within XTF_ENC_ATOL + XTF_ENC_RTOL x |CPU|."""
    import torch

    from pecos_tpu_torch.xmc.xtransformer import network

    for family, cfg in (families or XTF_FAMILIES).items():
        config_cls, model_cls, tok_cls = network.resolve_encoder(family)
        t0 = time.perf_counter()
        cpu = network.random_encoder(family, cfg, seed=SEED)
        init_s = time.perf_counter() - t0
        card = copy.deepcopy(cpu).to(device)
        n, T = XTF_FORWARD
        rng = np.random.default_rng(SEED + 14)
        ids = rng.integers(5, cfg["vocab_size"], size=(n, T))
        am = np.ones((n, T), np.int64)
        am[n // 2 :, T * 3 // 4 :] = 0  # half the rows padded at the end
        ids[am == 0] = getattr(cpu.config, "pad_token_id", 0) or 0
        ii, mm = torch.from_numpy(ids), torch.from_numpy(am)
        with torch.no_grad():
            want = network.pooled_embedding(cpu(input_ids=ii, attention_mask=mm), mm).numpy()
            card(input_ids=ii.to(device), attention_mask=mm.to(device))  # warm
            sync()
            t0 = time.perf_counter()
            got = network.pooled_embedding(card(input_ids=ii.to(device), attention_mask=mm.to(device)), mm.to(device)).cpu().numpy()
            fwd_s = time.perf_counter() - t0
        err = np.abs(got - want)
        bad = int((err > XTF_ENC_ATOL + XTF_ENC_RTOL * np.abs(want)).sum())
        n_params = sum(p.numel() for p in cpu.parameters())
        print(f"xtransformer encoder {family} [{smi}]: {model_cls.__module__}.{model_cls.__name__} ({config_cls.__name__}, "
              f"tokenizer {tok_cls.__name__}, attention {getattr(cpu.config, '_attn_implementation', None)}), "
              f"{n_params} parameters, CPU init {init_s!r} s; {n} x {T} tokens: card forward {fwd_s!r} s, pooled "
              f"{got.shape} card against CPU max_abs_err {float(err.max())!r} (largest {float(np.abs(want).max())!r}), bad {bad}")
        if bad or got.shape != (n, network.hidden_size(cpu.config)) or not np.isfinite(got).all():
            raise RuntimeError(f"xtransformer encoder {family}: {bad} pooled values outside atol {XTF_ENC_ATOL} + rtol {XTF_ENC_RTOL}")
        del cpu, card
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def xtf_data(tmp, corpus):
    """Phase 14's data from phase 13b's files, written in ``tmp``: the first
    XTF_N_TRN train lines and every test line, their label matrices, the
    item names, a Tfidf (T2T_VECTORIZER) trained on those train lines and its
    X of both, and a WordPiece vocab file of XTF_DISTILBERT's size."""
    from pecos_tpu_torch.utils.featurization.text import Preprocessor, Vectorizer

    t0 = time.perf_counter()
    items, trn, tst = make_t2t_files(tmp, corpus)
    d_trn = Preprocessor.load_data_from_file(trn, label_text_path=items)
    d_tst = Preprocessor.load_data_from_file(tst, label_text_path=items)
    with open(items, encoding="utf-8") as f:
        names = [l.rstrip("\n") for l in f]
    texts, Y = d_trn["corpus"][:XTF_N_TRN], d_trn["label_matrix"][:XTF_N_TRN].tocsr()
    t1 = time.perf_counter()
    vec = Vectorizer.train(texts, config=T2T_VECTORIZER)
    X, Xt = vec.predict(texts), vec.predict(d_tst["corpus"])
    vec_s = time.perf_counter() - t1
    data = dict(texts=texts, Y=Y, t_texts=d_tst["corpus"], Yt=d_tst["label_matrix"].tocsr(), names=names, vec=vec, X=X,
                Xt=Xt, vocab=write_vocab(tmp, texts, XTF_DISTILBERT["vocab_size"]))
    print(f"xtransformer data: {len(texts)} train texts (of phase 13b's {T2T_N_TRN}), {len(data['t_texts'])} test texts, "
          f"{Y.shape[1]} labels ({int((Y.getnnz(axis=0) > 0).sum())} with a train text); X_feat {X.shape} nnz {X.nnz} "
          f"(Tfidf {vec_s!r} s); vocab {XTF_DISTILBERT['vocab_size']} entries; {time.perf_counter() - t0!r} s in all")
    return data


def xtf_matcher_params(vocab, **kw):
    from pecos_tpu_torch.xmc.xtransformer import TransformerMatcher

    return TransformerMatcher.TrainParams(model_config=dict(XTF_DISTILBERT, vocab_file=vocab), **dict(XTF_MATCHER, **kw))


def run_xtransformer(device, smi, data, tmp):
    """Phase 14b: XTransformer.train and predict at DistilBERT-base width on
    ``data`` (xtf_data's); the TF-IDF-only XLinearModel bar; the saved folder
    (in ``tmp``) on the CPU; K1 at the ranker's shapes.  Returns (numbers, the
    preliminary chain)."""
    import torch

    from pecos_tpu_torch.ops.intersect import intersect_scores
    from pecos_tpu_torch.utils import smat_util
    from pecos_tpu_torch.xmc import Indexer, LabelEmbeddingFactory
    from pecos_tpu_torch.xmc.xlinear import XLinearModel
    from pecos_tpu_torch.xmc.xtransformer import MLProblemWithText, TransformerMatcher, XTransformer, network
    from pecos_tpu_torch.xmc.xtransformer.module import tokenize_corpus

    out = {}
    texts, Y, t_texts, Yt, X, Xt = (data[k] for k in ("texts", "Y", "t_texts", "Yt", "X", "Xt"))
    kw = dict(beam_size=T2T_BEAM, only_topk=T2T_TOPK)

    # phase 1's chain, shared with the TF-IDF-only bar: PIFA(Y, X_feat)
    t0 = time.perf_counter()
    chain = Indexer.gen(LabelEmbeddingFactory.create(Y, X, method="pifa"), device=device, **MR_INDEX)
    sync()
    index_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    base = XLinearModel.train(X, Y, C=chain, device=device, **XTF_RANKER)
    sync()
    base_s = time.perf_counter() - t0
    m = smat_util.Metrics.generate(Yt, base.predict(Xt, **kw), topk=T2T_TOPK)
    base_prec = [float(m.prec[0]), float(m.prec[4])]
    print(f"xtransformer TF-IDF-only bar [{smi}]: index {index_s!r} s (chain {[C.shape for C in chain]}), "
          f"XLinearModel.train {base_s!r} s; test P@1 {base_prec[0]!r}, P@5 {base_prec[1]!r}")
    del base
    gc.collect()

    tp = dict(matcher_params_chain=xtf_matcher_params(data["vocab"]), refined_indexer_params=dict(MR_INDEX))
    start = peak_reset()
    keep = lambda res: (res[0].nr_labels, res[0].train_losses, res[0].train_seconds)
    with CallTimes(TransformerMatcher, "train", keep=keep) as lvl, CallTimes(Indexer, "gen") as gen, \
            CallTimes(XLinearModel, "train") as rk:
        intersect_scores.launches = 0
        t0 = time.perf_counter()
        xtf = XTransformer.train(MLProblemWithText(texts, Y, X_feat=X), clustering=chain, train_params=tp,
                                 device=device, **XTF_RANKER)
        sync()
        train_s = time.perf_counter() - t0
        train_launches = intersect_scores.launches
    out["train_peak"] = peak_bytes() - start
    falls = []
    for (L_d, losses, loop_s), secs in zip(lvl.kept, lvl.seconds):
        first, last = float(losses[:50].mean()), float(losses[-50:].mean())
        falls.append(last < first)
        print(f"xtransformer level [{smi}]: {L_d} labels, {len(losses)} steps of {XTF_MATCHER['batch_size']} texts, "
              f"{secs!r} s (the step loop {loop_s!r} s, {len(losses) / loop_s!r} optimizer steps/s; the rest "
              f"tokenize and predict the train texts); mean loss of the first 50 steps {first!r}, of the last 50 {last!r}")
    kinds = [l.kind for l in xtf.concat_model.model._get_compiled().layers]
    n_plabel = kinds.count("plabel")
    print(f"xtransformer train [{smi}]: {train_s!r} s in all: fine-tune {sum(lvl.seconds)!r} s over {len(lvl.seconds)} levels, "
          f"refined index {gen.seconds!r} s, ranker XLinearModel.train {rk.seconds!r} s (negatives {XTF_RANKER['negative_sampling_scheme']}), "
          f"the rest {train_s - sum(lvl.seconds) - sum(gen.seconds) - sum(rk.seconds)!r} s; ranker layers {kinds} over "
          f"{xtf.concat_model.model.nr_features} features; K1 launches in train {train_launches}; peak device memory above "
          f"the start {out['train_peak']} bytes")
    if not all(falls):
        raise RuntimeError(f"xtransformer train: the loss did not fall at every level ({falls})")

    # predict: the test texts through the encoder, X_cat and the ranker's K1 levels
    peak_reset()
    intersect_scores.launches = 0
    P = xtf.predict(t_texts, X_feat=Xt, **kw)
    launches = intersect_scores.launches
    out["predict_peak"] = peak_bytes()
    want_launches = n_plabel * -(-len(t_texts) // BATCH)
    labels, scores = ranked(P, T2T_TOPK)
    m = smat_util.Metrics.generate(Yt, P, topk=T2T_TOPK)
    prec = [float(m.prec[0]), float(m.prec[4])]
    print(f"xtransformer predict [{smi}]: {len(t_texts)} test texts, beam {T2T_BEAM}, top {T2T_TOPK}: P@1 {prec[0]!r}, "
          f"P@5 {prec[1]!r} (the TF-IDF-only bar {base_prec}, P@1 window -{XTF_P1_MARGIN}); K1 launches {launches} (expected "
          f"{want_launches}: {n_plabel} plabel levels x {-(-len(t_texts) // BATCH)} batches); peak device memory {out['predict_peak']} bytes")
    if P.shape != (len(t_texts), Y.shape[1]) or not np.isfinite(scores).all():
        raise RuntimeError(f"xtransformer predict: {P.shape}, finite {np.isfinite(scores).all()}")
    if launches != want_launches or launches <= 0:
        raise RuntimeError(f"xtransformer predict: K1 launched {launches} times, expected {want_launches}")
    if prec[0] < base_prec[0] - XTF_P1_MARGIN:
        raise RuntimeError(f"xtransformer predict: P@1 {prec[0]!r} below the TF-IDF-only {base_prec[0]!r} - {XTF_P1_MARGIN}")

    # text in, items out, and its pieces (each best of 2)
    enc = xtf.text_encoder
    _, e2e_s = best_time(lambda: xtf.predict(t_texts, X_feat=Xt, **kw))
    toks, tok_s = best_time(lambda: tokenize_corpus(enc.tokenizer, t_texts, enc.pred_params.truncate_length), reps=1)
    emb, enc_s = best_time(lambda: network.encode_batches(enc.encoder, toks, enc.device).cpu().numpy(), reps=1)
    X_cat, cat_s = best_time(lambda: TransformerMatcher.concat_features(Xt, emb), reps=1)
    P2, rank_s = best_time(lambda: xtf.concat_model.predict(X_cat, **kw), reps=1)
    same = float((ranked(P2, T2T_TOPK)[0] == labels).mean())
    if same < XTF_MIN_CPU_AGREE:
        raise RuntimeError(f"xtransformer predict: the pieces' labels agree with XTransformer.predict's at {same!r}")
    qn = int(np.diff(X_cat.indptr).max())
    print(f"xtransformer predict [{smi}]: end to end (text in, items out) {len(t_texts) / e2e_s!r} QPS ({e2e_s!r} s); "
          f"tokenize {tok_s!r} s, encode {enc_s!r} s ({len(t_texts) / (tok_s + enc_s)!r} texts/s with the tokenizer), "
          f"concat {cat_s!r} s, ranker predict {rank_s!r} s (each once, after the two), the rest "
          f"{e2e_s - tok_s - enc_s - cat_s - rank_s!r} s; X_cat {X_cat.shape}, a row's nonzeros "
          f"up to {qn} (mean {X_cat.nnz / X_cat.shape[0]!r})")

    # the saved folder on the CPU: the port's encoder there, the ranker by the plain sparse-product predict
    folder = os.path.join(tmp, "xtf")
    xtf.save(folder)
    t0 = time.perf_counter()
    cpu = XTransformer.load(folder, device="cpu")
    n = min(XTF_CPU_TEXTS, len(t_texts))
    emb_cpu = cpu.encode(t_texts[:n])
    err = np.abs(emb_cpu - emb[:n])
    bad = int((err > XTF_ENC_ATOL + XTF_ENC_RTOL * np.abs(emb[:n])).sum())
    P_cpu = plain_xlinear_predict(cpu.concat_model, TransformerMatcher.concat_features(Xt[:n], emb_cpu), T2T_BEAM, T2T_TOPK)
    agree = float((ranked(P_cpu, T2T_TOPK)[0] == labels[:n]).mean())
    print(f"xtransformer CPU: the saved folder loaded with device='cpu' in {time.perf_counter() - t0!r} s with {n} texts: "
          f"embeddings max_abs_err {float(err.max())!r} against the card's, bad {bad}; (row, rank) labels of the plain "
          f"sparse-product predict equal to the card's {agree!r}")
    if bad or agree < XTF_MIN_CPU_AGREE:
        raise RuntimeError(f"xtransformer CPU: {bad} embedding values outside tolerance, label agreement {agree!r}")

    # K1 at the ranker's shapes: every plabel level, against the float64 sparse product
    k1_err = check_k1_text2text([xtf.concat_model], [cpu.concat_model], X_cat, what="xtransformer ranker")
    out["k1_timed"] = time_k1_path(device, xtf.concat_model, cpu.concat_model, X_cat[:BATCH], "xtransformer_ranker", smi)
    out.update(train_launches=train_launches, predict_launches=launches, k1_err=k1_err, prec=prec, base_prec=base_prec)
    return out, chain


def time_k1_path(device, xlm, host, X, name, smi, iters=10):
    """K1 by row id at the last plabel level of ``xlm`` on the queries X
    (one predict batch) over the children of the beam parents the plain
    predict chooses: the kernel at X's rows, and the kernel, the composite
    and the plain version side by side at a common N, the most rows whose
    plain compare block (N x K x P x its 64-query-id chunk) stays below
    2**31 elements; medians as time_k1's, with the bound at X's rows."""
    import torch

    from pecos_tpu_torch.ops.intersect import intersect_scores_rows, intersect_scores_rows_reference
    from pecos_tpu_torch.xmc import inference

    compiled = xlm.model._get_compiled()
    d = max(i for i, l in enumerate(compiled.layers) if l.kind == "plabel")
    layer = compiled.layers[d]
    A = X.tocsr().astype(np.float32)
    beams = []
    plain_xlinear_predict(host, A, T2T_BEAM, T2T_TOPK, beams=beams)
    parents = torch.from_numpy(np.clip(beams[d], 0, None).astype(np.int64)).to(compiled.device)
    q, v = (torch.from_numpy(a).to(compiled.device) for a in inference.prepare_queries_padded(A))
    table = layer.packed
    rows = layer.children[parents].reshape(parents.shape[0], -1)
    bias = (compiled.nr_features, compiled.bias) if compiled.bias > 0 else ()
    N, K = rows.shape
    P = table.shape[1] // 2
    m = min(N, max(1, (1 << 31) // (K * P * 64)))
    fns = {
        "kernel": lambda: intersect_scores_rows(q, v, table, rows, *bias),
        "kernel_common": lambda: intersect_scores_rows(q[:m], v[:m], table, rows[:m], *bias),
        "composite": lambda: k1_composite(q[:m], v[:m], table, rows[:m], *bias),
        "plain": lambda: intersect_scores_rows_reference(q[:m], v[:m], table, rows[:m], *bias),
    }
    outs = {key: fn() for key, fn in fns.items()}  # warm, and the four agree where they overlap
    err = max(float((outs[k][:m] - outs["plain"]).abs().max()) for k in ("kernel", "kernel_common", "composite"))
    if not err <= 1e-4 * max(float(outs["plain"].abs().max()), 1.0):
        raise RuntimeError(f"K1 timing {name}: kernel or composite differ from the plain version by {err!r}")
    del outs
    t = time_calls(device, fns, iters)
    bound_ms, bound_by, n_bytes = k1_bound(v, table, rows, P)
    entry = {"N": N, "K": K, "P": P, "Qn": int(q.shape[1]), "table_rows": int(table.shape[0]), "ms": t["kernel"],
             "common_N": m, "common_ms": t["kernel_common"], "plain_ms": t["plain"], "composite_ms": t["composite"],
             "bound_ms": bound_ms, "bound_by": bound_by, "bytes": n_bytes, "share": bound_ms / t["kernel"]}
    print(f"K1 timing {name} (by id, level {d}, N={N} K={K} P={P} Qn={entry['Qn']}, table of {entry['table_rows']} rows, "
          f"L2 flushed, median of CUDA events) [{smi}]: kernel {t['kernel']!r} ms, bound {bound_ms!r} ms ({bound_by}, "
          f"{n_bytes} bytes), share of bound {entry['share']!r}; at N={m}: kernel {t['kernel_common']!r} ms, "
          f"searchsorted composite {t['composite']!r} ms, plain {t['plain']!r} ms")
    return entry


def run_dist_fine_tune(device, smi, data, chain):
    """Phase 14c: dist_fine_tune over a mesh of XTF_DIST_DEVICES slots (the
    cards, or the one card repeated) against TransformerMatcher.train on one
    device: XTF_DIST_STEPS steps of the first level on the first
    XTF_DIST_TEXTS train texts, dropout 0; weights within XTF_DIST_REL of
    the single device's movement from the initial weights."""
    import torch

    from pecos_tpu_torch.distributed.xmc.xtransformer import dist_fine_tune
    from pecos_tpu_torch.utils import smat_util
    from pecos_tpu_torch.xmc.xtransformer import MLProblemWithText, TransformerMatcher, network

    Y0 = data["Y"]
    for C in reversed(list(chain)[1:]):
        Y0 = Y0 @ C
    n = min(XTF_DIST_TEXTS, len(data["texts"]))
    prob = MLProblemWithText(data["texts"][:n], smat_util.binarized(Y0.tocsr()[:n]))
    tp = xtf_matcher_params(data["vocab"], max_steps=XTF_DIST_STEPS)
    tp.model_config.update(dropout=0.0, attention_dropout=0.0)
    init = network.random_encoder(tp.model_type, tp.model_config, seed=tp.seed).state_dict()
    one, _, _ = TransformerMatcher.train(prob, train_params=tp, device=device)
    dist, _, _ = dist_fine_tune(prob, train_params=tp, n_devices=XTF_DIST_DEVICES, device=device.type)
    a, b = one.encoder.state_dict(), dist.encoder.state_dict()
    diff = sum(float((b[k].cpu() - a[k].cpu()).double().square().sum()) for k in init)
    moved = sum(float((a[k].cpu() - init[k]).double().square().sum()) for k in init)
    diff += float(np.square(dist.head.W.astype(np.float64) - one.head.W).sum() + np.square(dist.head.b.astype(np.float64) - one.head.b).sum())
    moved += float(np.square(one.head.W.astype(np.float64) - network.XMCHead.random(prob.nr_labels, one.hidden_size, tp.seed).W).sum())
    rel = (diff / max(moved, 1e-30)) ** 0.5
    max_abs = max(float((b[k].cpu() - a[k].cpu()).abs().max()) for k in init)
    loss_rel = float(np.abs(dist.train_losses - one.train_losses).max() / np.abs(one.train_losses).max())
    total = one.moment_bytes[0]
    print(f"xtransformer dist_fine_tune [{smi}]: {XTF_DIST_STEPS} steps of level 0 ({prob.nr_labels} labels, {n} texts), "
          f"mesh of {XTF_DIST_DEVICES} slots: step loop {dist.train_seconds!r} s against {one.train_seconds!r} s on one device; "
          f"||mesh - one|| / ||one - init|| {rel!r} (max abs diff {max_abs!r}); losses max rel diff {loss_rel!r}; moment "
          f"bytes per slot {dist.moment_bytes} (sum {sum(dist.moment_bytes)}, one device's {total}, a quarter {total / 4!r})")
    if rel > XTF_DIST_REL or loss_rel > XTF_DIST_REL or sum(dist.moment_bytes) != total:
        raise RuntimeError(f"xtransformer dist_fine_tune: {rel!r} / {loss_rel!r} against the single device (limit {XTF_DIST_REL})")
    if max(dist.moment_bytes) > 0.3 * total:
        raise RuntimeError(f"xtransformer dist_fine_tune: a slot holds {max(dist.moment_bytes)} of {total} moment bytes")
    del one, dist
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reranker_pairs(data, n_queries, seed=SEED):
    """Groups of 4 (query, item) pairs: a test text with its first label's
    item name (relevance 1) and three other items drawn uniformly (0); two
    numeric features a pair: the Tfidf cosine of query and item name, and
    log(1 + the item's count among the train labels)."""
    from pecos_tpu_torch.utils import smat_util

    rng = np.random.default_rng(seed + 15)
    Yt, names = data["Yt"], data["names"]
    rows = [i for i in range(Yt.shape[0]) if Yt.indptr[i + 1] > Yt.indptr[i]][:n_queries]
    freq = np.log1p(np.asarray(data["Y"].sum(axis=0)).ravel())
    Xq = smat_util.normalize(data["Xt"][rows], axis=1, norm="l2")
    Xi = smat_util.normalize(data["vec"].predict(names), axis=1, norm="l2")
    inputs, labels, items = [], [], []
    for r in rows:
        pos = int(Yt.indices[Yt.indptr[r]])
        neg = rng.choice(np.setdiff1d(np.arange(len(names)), Yt.indices[Yt.indptr[r] : Yt.indptr[r + 1]]), 3, replace=False)
        for j, rel in zip([pos, *neg.tolist()], (1.0, 0.0, 0.0, 0.0)):
            inputs.append(f"{data['t_texts'][r]} [SEP] {names[j]}")
            labels.append(rel)
            items.append(j)
    qi = np.repeat(np.arange(len(rows)), 4)
    cos = np.asarray(Xq[qi].multiply(Xi[np.asarray(items)]).sum(axis=1)).ravel()
    numr = np.stack([cos, freq[np.asarray(items)]], axis=1).astype(np.float32)
    return inputs, np.asarray(labels, np.float32), numr


def run_reranker(device, smi, data):
    """Phase 14d: RankingModel at DistilBERT-base width with LoRA on the
    reranker pairs; the loss falls, the frozen base stays bit-equal, and the
    saved folder on the CPU scores as the card within RR_ATOL."""
    import torch

    from pecos_tpu_torch.xmc.xtransformer import network
    from pecos_tpu_torch.xmr.reranker import RankingModel
    from pecos_tpu_torch.xmr.reranker import model as rmodel

    inputs, labels, numr = reranker_pairs(data, RR_QUERIES)
    tp = dict(RR_TRAIN, model_config=dict(XTF_DISTILBERT, vocab_file=data["vocab"]))
    sync()
    t0 = time.perf_counter()
    model = RankingModel.train(inputs, labels, numeric_feats=numr, train_params=tp, device=device)
    sync()
    train_s = time.perf_counter() - t0
    losses = model.train_losses
    first, last = float(losses[:50].mean()), float(losses[-50:].mean())
    init = network.random_encoder(tp["model_type"], tp["model_config"], seed=tp["seed"]).state_dict()
    wrapped = [n for n, m in model.enc.encoder.named_modules() if isinstance(m, rmodel.LoRALinear)]
    base = {k.replace(".base.", "."): v.cpu() for k, v in model.enc.encoder.state_dict().items() if "lora_" not in k}
    frozen = all(torch.equal(v, init[k]) for k, v in base.items()) and set(base) == set(init)
    n_pred = min(RR_PREDICT_PAIRS, len(inputs))
    trunc = dict(truncate_length=tp["truncate_length"])
    scores, pred_s = best_time(lambda: model.predict(inputs[:n_pred], numeric_feats=numr[:n_pred], **trunc))
    acc = float((scores.reshape(-1, 4).argmax(axis=1) == 0).mean())
    print(f"reranker [{smi}]: {len(inputs)} pairs in groups of 4, LoRA rank {tp['lora_rank']} on {len(wrapped)} projections "
          f"({tp['lora_targets']}), {tp['loss_fn']} loss, {len(losses)} steps of {tp['batch_size']} pairs: train {train_s!r} s "
          f"({len(losses) * tp['batch_size'] / train_s!r} pairs/s with set-up; the steps and tokenization included); "
          f"mean loss of the first 50 steps {first!r}, of the last 50 {last!r}; frozen base bit-equal {frozen}; predict "
          f"{n_pred / pred_s!r} pairs/s ({n_pred} pairs, best of 2), top-1 of 4 {acc!r}")
    if not last < first or not frozen:
        raise RuntimeError(f"reranker: loss {first!r} -> {last!r}, frozen base bit-equal {frozen}")
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        cpu = RankingModel.load(tmp, device="cpu")
        n = RR_CPU_PAIRS
        got = cpu.predict(inputs[:n], numeric_feats=numr[:n], **trunc)
        err = float(np.abs(got - scores[:n]).max())
    print(f"reranker CPU: the saved folder (LoRA merged) loaded with device='cpu', {n} pairs: max_abs_err {err!r} against "
          f"the card's scores (largest {float(np.abs(scores[:n]).max())!r})")
    if not err <= RR_ATOL:
        raise RuntimeError(f"reranker CPU: scores differ by {err!r} > {RR_ATOL}")
    del model, cpu
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_phase14(device, smi, corpus):
    """Phase 14 (a)-(d); returns phase 14b's numbers."""
    import transformers

    transformers.utils.logging.set_verbosity_error()
    transformers.utils.logging.disable_progress_bar()
    t0 = time.perf_counter()
    run_encoder_families(device, smi)
    t_a = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        data = xtf_data(tmp, corpus)
        numbers, chain = run_xtransformer(device, smi, data, tmp)
        gc.collect()
        t_b = time.perf_counter()
        run_dist_fine_tune(device, smi, data, chain)
        t_c = time.perf_counter()
        run_reranker(device, smi, data)
    print(f"xtransformer phase 14 [{smi}]: {time.perf_counter() - t0!r} s: (a) {t_a - t0!r}, (b) {t_b - t_a!r}, "
          f"(c) {t_c - t_b!r}, (d) {time.perf_counter() - t_c!r}")
    return numbers


def profile_xtransformer(device, smi, n_predict=2048):
    """``--profile-xtransformer``: torch.profiler over the first level's
    TransformerMatcher.train (its step loop and its predict of the train
    texts) on phase 14b's data, then over XTransformer.predict of
    ``n_predict`` test texts, with a ranker trained on [X_feat || that
    level's embeddings] over the preliminary chain."""
    import torch
    import transformers
    from torch.profiler import ProfilerActivity, profile

    from pecos_tpu_torch.utils import smat_util
    from pecos_tpu_torch.xmc import Indexer, LabelEmbeddingFactory
    from pecos_tpu_torch.xmc.xlinear import XLinearModel
    from pecos_tpu_torch.xmc.xtransformer import MLProblemWithText, TransformerMatcher, XTransformer

    transformers.utils.logging.set_verbosity_error()
    transformers.utils.logging.disable_progress_bar()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    corpus = load_script("tokenizer_bench").make_corpus(**T2T_CORPUS)
    tmp = tempfile.TemporaryDirectory()
    data = xtf_data(tmp.name, corpus)
    chain = Indexer.gen(LabelEmbeddingFactory.create(data["Y"], data["X"], method="pifa"), device=device, **MR_INDEX)
    Y0 = data["Y"]
    for C in reversed(list(chain)[1:]):
        Y0 = Y0 @ C
    prob = MLProblemWithText(data["texts"], smat_util.binarized(Y0.tocsr()))
    tp = xtf_matcher_params(data["vocab"])
    TransformerMatcher.train(MLProblemWithText(data["texts"][:256], prob.Y[:256]), train_params=xtf_matcher_params(
        data["vocab"], max_steps=2), device=device)  # first launches
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        matcher, _, emb = TransformerMatcher.train(prob, train_params=tp, device=device)
        sync()
        wall = time.perf_counter() - t0
    print(f"xtransformer level 0: {len(matcher.train_losses)} steps, step loop {matcher.train_seconds!r} s, the rest "
          f"(tokenize, predict {len(data['texts'])} train texts) {wall - matcher.train_seconds!r} s")
    print_profile(prof, wall, f"xtransformer level-0 train ({len(matcher.train_losses)} steps + predict of the train texts)", smi)
    del prof
    ranker = XLinearModel.train(TransformerMatcher.concat_features(data["X"], emb), data["Y"], C=chain, device=device, **XTF_RANKER)
    xtf = XTransformer(matcher, ranker)
    kw = dict(beam_size=T2T_BEAM, only_topk=T2T_TOPK)
    texts, Xt = data["t_texts"][:n_predict], data["Xt"][:n_predict]
    xtf.predict(texts[:BATCH], X_feat=Xt[:BATCH], **kw)
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        xtf.predict(texts, X_feat=Xt, **kw)
        sync()
        wall = time.perf_counter() - t0
    print_profile(prof, wall, f"xtransformer predict ({len(texts)} texts)", smi)
    tmp.cleanup()


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


# ---------------------------------------------------------------------------
# phase 15: HNSW's build options and the FM example
# ---------------------------------------------------------------------------


def ann_option_build(X, what, device, smi, **kw):
    """One of phase 15's builds on ``device``: (model, numbers) with its
    seconds, peak memory above the start and K1 launches."""
    from pecos_tpu_torch.ann import HNSW
    from pecos_tpu_torch.ops.intersect import intersect_scores

    gc.collect()
    mem0 = peak_reset()
    intersect_scores.launches = 0
    t0 = time.perf_counter()
    model = HNSW.train(X, device=device, **ANN_BUILD, **kw)
    sync()
    secs = time.perf_counter() - t0
    launches = intersect_scores.launches
    peak = peak_bytes() - mem0
    print(f"ann options {what} build [{smi}]: {kw}, M={ANN_BUILD['M']} efC={ANN_BUILD['efC']}, {X.shape[0]} points: "
          f"{secs!r} s, peak device memory above the start {peak} bytes, K1 launches {launches}")
    return model, {"build_s": secs, "peak_bytes": peak, "build_launches": launches}


def ann_option_recall(model, what, queries, recall, efs, bar, smi):
    """recall(ids) of one build's search at each efS (QPS best of 2, K1
    launches a search); raises below ``bar`` at efS=100."""
    from pecos_tpu_torch.ops.intersect import intersect_scores

    numbers, reps = {}, 2
    for efS in efs:
        intersect_scores.launches = 0
        (ids, dists), secs = best_time(lambda: model.predict(queries, efS=efS, topk=ANN_TOPK), reps)
        launches = intersect_scores.launches // reps
        if ids.shape != (queries.shape[0], ANN_TOPK) or ids.min() < 0 or not np.isfinite(dists).all():
            raise RuntimeError(f"ann options {what} efS={efS}: ids {ids.shape} from {ids.min()}, or distances not finite")
        rec = recall(ids)
        numbers[f"efS{efS}"] = {"recall": rec, "qps": queries.shape[0] / secs, "launches": launches}
        print(f"ann options {what} predict efS={efS} [{smi}]: recall@{ANN_TOPK} {rec!r}, {queries.shape[0] / secs!r} QPS "
              f"(best of 2, {secs!r} s), K1 launches {launches}")
    if numbers["efS100"]["recall"] < bar:
        raise RuntimeError(f"ann options {what}: recall@{ANN_TOPK} {numbers['efS100']['recall']!r} < {bar} at efS=100")
    return numbers


def run_fm(device, smi):
    """Phase 15f: the FM example's demo settings, one CPU draw of the
    starting parameters fitted on ``device`` and on the CPU; returns numbers."""
    import contextlib
    import io

    from pecos_tpu_torch.examples import fm_for_xmc as fm

    Xq, Y, Xp, _ = fm.synthetic_pairs()
    params = fm.FMParams(seed=SEED, **FM_DEMO)
    theta = fm.FactorizationMachine.init_params(Xq.shape[1], Xp.shape[1], params, device="cpu")
    fit_args = (Xq[:-FM_N_VAL], Y[:-FM_N_VAL], Xp)
    val = dict(Xq_val=Xq[-FM_N_VAL:], Y_val=Y[-FM_N_VAL:])
    out, secs, log = {}, {}, {}
    for where, th in (("card", {n: v.to(device) for n, v in theta.items()}), ("cpu", theta)):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out[where] = fm.FactorizationMachine.fit(*fit_args, th, params, **val)
        sync()
        secs[where], log[where] = time.perf_counter() - t0, buf.getvalue().splitlines()
    S, S_cpu = (out[w].score(Xq[-FM_N_VAL:], Xp) for w in ("card", "cpu"))
    truth = np.asarray(Y[-FM_N_VAL:].todense())
    p1 = float(np.mean(truth[np.arange(FM_N_VAL), S.argmax(axis=1)] > 0))
    Eq, Ep = out["card"].to_sip_embeddings(Xq[-FM_N_VAL:], Xp)
    sip_err = float(np.abs(Eq @ Ep.T - S).max())
    err, scale = float(np.abs(S - S_cpu).max()), float(np.abs(S_cpu).max())
    print(f"fm [{smi}]: {FM_DEMO}, {Xq.shape[0] - FM_N_VAL} train / {FM_N_VAL} held-out queries x {Xp.shape[0]} products: "
          f"card {secs['card']!r} s ({len(log['card'])} epochs; {log['card'][-1]}), CPU {secs['cpu']!r} s "
          f"({len(log['cpu'])} epochs); held-out P@1 {p1!r}, SIP max |error| {sip_err!r}, "
          f"card against CPU scores max |diff| {err!r} (largest |score| {scale!r})")
    if not p1 > FM_MIN_P1 or not sip_err <= FM_SIP_ATOL or not err <= FM_SCORE_RTOL * scale:
        raise RuntimeError(f"fm: P@1 {p1!r} (> {FM_MIN_P1}), SIP error {sip_err!r} (<= {FM_SIP_ATOL}), card against "
                           f"CPU {err!r} (<= {FM_SCORE_RTOL} x {scale!r}) out of bounds")
    return {"fit_s": secs["card"], "cpu_fit_s": secs["cpu"], "p1": p1, "sip_err": sip_err, "cpu_err": err}


def run_phase15(device, smi, dense, sparse):
    """Phase 15 (a)-(f) on phase 11's data: dense = (base, queries, exact
    top-10 ids), sparse = (X, Q, ground-truth distances); returns numbers."""
    import torch

    from pecos_tpu_torch.ann import HNSW

    t_start = time.perf_counter()
    base, queries, true_ids = dense
    X, Q, gt_d = sparse
    data = {"dense": (base, queries, lambda ids: recall_at(ids, true_ids)),
            "sparse": (X, Q, lambda ids: sparse_tie_recall(ids, X, Q, gt_d))}
    numbers = {}
    for what, (kind, kw, efs, bar) in ANN_OPT_BUILDS.items():
        feats, qs, recall = data[kind]
        model, numbers[what] = ann_option_build(feats, what, device, smi, **kw)
        if kind == "sparse" and numbers[what]["build_launches"] <= 0:
            raise RuntimeError(f"ann options {what} build: K1 was not launched")
        numbers[what].update(ann_option_recall(model, what, qs, recall, efs, bar, smi))
        if what == "dense build_pq":  # (e)
            Qc, kw_c = qs[:ANN_CPU_CHECK], dict(efS=100, topk=ANN_TOPK)
            ids = model.predict(Qc, **kw_c)[0]
            with tempfile.TemporaryDirectory(prefix="pecos_hnsw_opt_") as folder:
                model.save(folder)
                again = HNSW.load(folder, device=device).predict(Qc, **kw_c)[0]
            print(f"ann options {what}: saved, loaded and searched again on {ANN_CPU_CHECK} queries, ids equal "
                  f"{bool(np.array_equal(again, ids))}")
            if not np.array_equal(again, ids):
                raise RuntimeError(f"ann options {what}: the loaded index gave other ids")
        del model
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    numbers["fm"] = run_fm(device, smi)
    print(f"ann options and fm phase 15 [{smi}]: {time.perf_counter() - t_start!r} s")
    return numbers


def time_k1_shapes(device, smi, shapes):
    """Phase 4: K1 timed at each of ``shapes`` (K1_TIMED's form), one line each; returns name -> numbers."""
    timed = {}
    for shape, N, K, P_, Qn, layout, pad, bias, R in shapes:
        t = time_k1(device, shape, N, K, P_, Qn, layout, pad, bias, R, iters=10 if N * K > 200_000 else 20)
        timed[shape] = t
        print(f"K1 timing {shape} (by id, N={N} K={K} P={P_} Qn={Qn}, table of {R} rows, L2 flushed, median of "
              f"CUDA events) [{smi}]: kernel {t['ms']!r} ms, bound {t['bound_ms']!r} ms ({t['bound_by']}, "
              f"{t['bytes']} bytes), share of bound {t['share']!r}; plain {t['plain_ms']!r} ms, "
              f"searchsorted composite {t['composite_ms']!r} ms")
    return timed


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
    if sys.argv[1:] == ["--profile-xtransformer"]:
        profile_xtransformer(device, smi)
        return 0
    if sys.argv[1:] == ["--xtransformer"]:
        run_phase14(device, smi, load_script("tokenizer_bench").make_corpus(**T2T_CORPUS))
        return 0
    if sys.argv[1:2] == ["--f8-cost"] and len(sys.argv) == 3:
        f8_cost(device, smi, os.path.abspath(sys.argv[2]))
        return 0
    if sys.argv[1:] == ["--grouped-gemm"]:
        run_grouped_gemm(device, smi)
        return 0
    if sys.argv[1:] == ["--ann-options"]:
        check_k1_rows(device, [(f"{name} by id", *shape) for name, *shape in K1_OPTION_SHAPES])
        time_k1_shapes(device, smi, K1_OPTION_SHAPES)
        base, queries, true_ids, _ = ann_dense_data(device)
        X, Q, _, gt_d, _ = ann_sparse_data()
        run_phase15(device, smi, (base, queries, true_ids), (X, Q, gt_d))
        return 0

    # 3. K1 against its plain version: over gathered blocks, then by row id
    max_err = max(check_k1(device), check_k1_rows(device))

    # 4. K1 timing by row id, at the main paths' shapes
    timed = time_k1_shapes(device, smi, K1_TIMED)
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
    # (the data stays on the host for phase 15)
    hnsw, base, queries, true_ids, _ = run_ann_dense(device, smi)
    run_ann_pq(hnsw, queries, true_ids, smi)
    del hnsw
    gc.collect()
    torch.cuda.empty_cache()
    sparse_build_launches, sparse_predict_launches, _, (X_ann, Q_ann, _, gt_d_ann) = run_ann_sparse(device, smi)
    run_ann_pairwise(base, device, smi)
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

    # 13. text2text: Tfidf at the tokenizer benchmark's protocol, then Text2Text trained and served on the card,
    # then PIFA's SpGEMM on its train data
    corpus = run_tfidf()
    t2t_launches, t2t_k1_err = run_text2text(device, smi, corpus)
    max_err = max(max_err, t2t_k1_err)
    run_spgemm(smi, corpus)
    gc.collect()
    torch.cuda.empty_cache()

    # 14. XR-Transformer: the encoder families, XTransformer train and predict, dist_fine_tune, the reranker
    xtf = run_phase14(device, smi, corpus)
    max_err = max(max_err, xtf["k1_err"])
    timed["xtransformer_ranker"] = xtf["k1_timed"]
    gc.collect()
    torch.cuda.empty_cache()

    # 15. HNSW's build options on phase 11's data, and the FM example
    opt = run_phase15(device, smi, (base, queries, true_ids), (X_ann, Q_ann, gt_d_ann))

    print(f"gpu: {smi}")
    pred = timed["predict"]
    kernels = [{
        "name": "intersect_scores", "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
        "launches": launches, "max_abs_err": max_err, "ms": pred["ms"], "plain_ms": pred["plain_ms"],
        "bound_ms": pred["bound_ms"], "bound_by": pred["bound_by"], "library_ms": None,
        "share": pred["share"], "composite_ms": pred["composite_ms"],
        "shapes": {shape: {k: t[k] for k in ("N", "K", "P", "Qn", "ms", "common_N", "common_ms", "plain_ms", "composite_ms",
                                             "bound_ms", "bound_by", "share") if k in t}
                   for shape, t in timed.items()},
        "launches_by_path": {
            "predict": launches, **{f"wire_{dt}": n for dt, n in wire_launches.items()},
            "realtime": realtime_launches, "compiled_eager": eager_launches, "compiled_lazy": lazy_launches,
            "train_golden": golden_launches, "train_predict": train_launches,
            "ann_sparse_build": sparse_build_launches, "ann_sparse_predict": sparse_predict_launches,
            "sharded_predict": sharded_launches, "text2text_predict": t2t_launches,
            "xtransformer_train": xtf["train_launches"], "xtransformer_predict": xtf["predict_launches"],
            **{f"ann_options_{what.replace(' ', '_')}_build": opt[what]["build_launches"] for what in ANN_OPT_BUILDS},
            **{f"ann_options_{what.replace(' ', '_')}_predict": opt[what]["efS100"]["launches"] for what in ANN_OPT_BUILDS},
        },
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
