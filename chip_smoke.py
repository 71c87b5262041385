"""Smoke run of the PyTorch + CUDA port (pecos_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a line; any failed check raises and the run exits
non-zero:

1. device  — needs torch.cuda; prints the card's name and power limit.
2. build   — compiles the CUDA kernels from pecos_tpu_torch/ops/csrc.
3. K1      — the intersection kernel against its plain PyTorch version on the
             card, at the predict path's shape and at ragged, long-query and
             padded shapes.
4. timing  — kernel and plain version at the predict path's shape.
5. predict — XLinearModel.predict of 8,192 sparse queries through a random
             model of the Wiki-500K geometry (the repo's bench.py model:
             L=524,288, D=262,144, 64 weights per label, 16-way tree, beam 10,
             top 20), checked for shape, K1 launches and agreement with the
             same model on the CPU.
6. numbers — end-to-end QPS, compute ms per 1,024-query batch, peak memory.

The line before the last is a JSON object describing each kernel of the path;
the last line is {"ok": true, "device": {...}}.
"""

import json
import statistics
import subprocess
import sys
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
    pad ids D_feat+1 (value 0) and zero-valued weight pad slots (id 0)."""
    rng = np.random.default_rng(seed)
    qids = unique_rows(rng, N, Qn, D_feat)
    qvals = rng.standard_normal((N, Qn)).astype(np.float32)
    wi = unique_rows(rng, N * K, P, D_feat + 1).reshape(N, K, P)
    wv = rng.standard_normal((N, K, P)).astype(np.float32)
    if pad:
        qpad = np.arange(Qn)[None, :] >= (Qn - rng.integers(0, Qn // 2 + 1, size=N))[:, None]
        qids[qpad], qvals[qpad] = D_feat + 1, 0.0
        wpad = np.arange(P)[None, None, :] >= (P - rng.integers(0, P // 2 + 1, size=(N, K)))[:, :, None]
        wi[wpad], wv[wpad] = 0, 0.0
    return qids, qvals, np.concatenate([wi, wv.view(np.int32)], axis=-1)


# (name, N, K, P, Qn, pad, bias): the predict path's shape with and without the
# bias term, a ragged shape, a query longer than one shared-memory chunk (512),
# and padded rows
K1_CASES = [
    ("main+bias", 1024, 160, 64, 256, False, True),
    ("main", 1024, 160, 64, 256, False, False),
    ("ragged", 3, 37, 8, 5, True, True),
    ("long-query", 8, 37, 64, 4096, True, True),
    ("padded", 64, 160, 64, 256, True, True),
]


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


def time_k1(device, iters=20):
    """Median ms of the kernel and of the plain version at the predict path's
    shape, timed with CUDA events in alternating turns."""
    import torch

    from pecos_tpu_torch.ops.intersect import intersect_scores, intersect_scores_reference

    D_feat = 1024
    qids, qvals, w = make_k1_case(1024, 160, 64, 256, D_feat, False, seed=1)
    args = [torch.from_numpy(a).to(device) for a in (qids, qvals, w)] + [D_feat, 1.0]
    fns = {"kernel": intersect_scores, "plain": intersect_scores_reference}
    for fn in fns.values():  # warm
        fn(*args)
    times = {k: [] for k in fns}
    for i in range(iters):
        for key in (("kernel", "plain") if i % 2 == 0 else ("plain", "kernel")):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fns[key](*args)
            end.record()
            end.synchronize()
            times[key].append(start.elapsed_time(end))
    return statistics.median(times["kernel"]), statistics.median(times["plain"])


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


def check_predict(P, P_cpu, n_labels, n_queries, n_plabel, batch, launches):
    """Shape, launch count and CPU agreement checks of phase 5; returns the
    label agreement share."""
    if P.shape != (n_queries, n_labels):
        raise RuntimeError(f"prediction shape {P.shape} != {(n_queries, n_labels)}")
    labels, scores = ranked(P, TOPK)
    if labels.min() < 0 or labels.max() >= n_labels or not np.isfinite(scores).all():
        raise RuntimeError("labels out of range or scores not finite")
    want_launches = n_plabel * -(-n_queries // batch)
    if launches != want_launches:
        raise RuntimeError(f"K1 launched {launches} times in the predict run, expected {want_launches}")
    c_labels, c_scores = ranked(P_cpu, TOPK)
    n_cpu = c_labels.shape[0]
    same = labels[:n_cpu] == c_labels
    agree = float(same.mean())
    print(f"predict: label agreement with the CPU run on {n_cpu} queries: {agree!r}")
    if agree < 0.995:
        raise RuntimeError(f"label agreement {agree!r} < 0.995")
    if not np.allclose(scores[:n_cpu][same], c_scores[same], rtol=1e-4, atol=0.0):
        raise RuntimeError("scores of agreeing labels differ beyond rtol=1e-4")
    return agree


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke runs on a GPU only", file=sys.stderr)
        return 1
    from pecos_tpu_torch.ops import _build
    from pecos_tpu_torch.ops.intersect import intersect_scores
    from pecos_tpu_torch.xmc.inference import prepare_queries_padded

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

    # 3. K1 against its plain version
    max_err = check_k1(device)

    # 4. K1 timing
    k_ms, plain_ms = time_k1(device)
    print(f"K1 timing (N=1024 K=160 P=64 Qn=256, median of 20, CUDA events): kernel {k_ms!r} ms, "
          f"plain {plain_ms!r} ms [{smi}]")

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
    P_cpu = xlinear(Ws, Cs, "cpu").predict(X[:N_CPU_CHECK], **kw)
    check_predict(P, P_cpu, L, N_QUERIES, n_plabel, BATCH, launches)
    print(f"predict: {N_QUERIES} queries -> {P.shape}, {P.nnz} entries, K1 launches {launches}")

    # 6. numbers
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        xlm.predict(X, **kw)
        best = min(best, time.perf_counter() - t0)
    ids, vals = prepare_queries_padded(X[:BATCH], cap=Q_NNZ)
    ids_d, vals_d = torch.from_numpy(ids).to(device), torch.from_numpy(vals).to(device)
    pp_names = ("l3-hinge",) * compiled.depth
    has_dense = compiled.uses_dense_queries(BATCH, Q_NNZ)
    run = lambda: compiled.predict_padded(
        ids_d, vals_d, beam_size=BEAM, only_topk=TOPK, pp_names=pp_names, has_dense=has_dense
    )
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

    print(f"gpu: {smi}")
    kernels = [{
        "name": "intersect_scores", "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
        "launches": launches, "max_abs_err": max_err, "ms": k_ms, "plain_ms": plain_ms,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
