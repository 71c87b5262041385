"""The benchmark's general machinery: one run of one cell.

``run.py`` is the command; this module does the work, so that the tests can
drive a whole run on the CPU at a tiny size.  Everything that belongs to one
configuration, traffic mix, cell or per-layer metric lives in files of its
own, found by the names in ``BENCHMARK.json``:

- ``configs/<config>.json`` (the file ``BENCHMARK.json`` names), whose
  ``model`` key names a model kind: ``models/<model>.py`` (its ``Model``,
  ``Program`` and queries), ``models/<model>_reference.py`` and
  ``models/<model>_work.py``, which this module drives through the contract
  that ``portbench/README.md`` writes out and never looks inside;
- ``traffic/<mix>.json``: the mix's parameters, read by ``traffic.py``;
- ``cells/<cell>.json``: the cell's own limits for the comparison, and the
  traffic parameters only it sets (an open loop's rate);
- ``metrics/<metric>.py``: a ``read(ctx)`` that returns the metric or None.

A run: set-up (weights and queries from the seed, the program built and
every shape the cell uses warmed), the measured window, then, with the
program's state freed, the plain reference over a sample of what the window
served, drawn from the seed.
"""

from __future__ import annotations

import gc
import hashlib
import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = os.path.basename(HERE)
# top-level module names that no process of the benchmark may hold
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "pecos_tpu")
# compile caches of the program, at fixed paths inside the checkout
CACHE_DIRS = {"TRITON_CACHE_DIR": "_cache/triton", "TORCH_EXTENSIONS_DIR": "_cache/torch_extensions"}
# environment that keeps libraries the port may use from loading JAX or TensorFlow
QUIET_ENV = {"USE_FLAX": "0", "USE_JAX": "0", "USE_TF": "0"}
K1_KERNEL = "intersect_scores_kernel"
# sampled queries a time whose beams' spread over the leaf clusters is logged
SPREAD_QUERIES = 1024


def set_environment() -> None:
    for key, sub in CACHE_DIRS.items():
        path = os.path.join(HERE, sub)
        os.makedirs(path, exist_ok=True)
        os.environ[key] = path
    os.environ.update(QUIET_ENV)


def forbidden_modules() -> List[str]:
    """The forbidden top-level names that ``sys.modules`` holds."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


# ---------------------------------------------------------------------------
# the files that describe the cells
# ---------------------------------------------------------------------------


def read_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict:
    return read_json(os.path.join(root, "BENCHMARK.json"))


def named(entries: List[Dict], name: str, what: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def applies(entry: Dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


class Cell:
    """One workload of BENCHMARK.json with its configuration, mix and limits."""

    def __init__(self, name: str, root: str = ROOT, entry: Optional[Dict] = None):
        """``entry`` stands for a workload that BENCHMARK.json does not
        declare (yet): its name, config, traffic and chips."""
        self.bench = benchmark(root)
        self.name = name
        self.entry = entry or named(self.bench["workloads"], name, "workload")
        self.cfg = read_json(os.path.join(root, named(self.bench["configs"], self.entry["config"], "config")["file"]))
        self.own = read_json(os.path.join(root, NAME, "cells", name + ".json"))
        self.mix = read_json(os.path.join(root, NAME, "traffic", self.entry["traffic"] + ".json"))
        self.mix.update(self.own.get("traffic", {}))
        self.limits = {k: float(v) for k, v in self.own["limits"].items()}
        self.end_to_end = [m for m in self.bench["end_to_end"] if applies(m, name)]
        self.per_layer = [m for m in self.bench["per_layer"] if applies(m, name)]
        self.kind = self.cfg["model"]

    def module(self, part: str = ""):
        return importlib.import_module(f"portbench.models.{self.kind}{part}")


def metric_reader(name: str, root: str = ROOT) -> Callable[[Dict], Optional[float]]:
    path = os.path.join(root, NAME, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def digest(arrays) -> str:
    """sha256 of a pool's arrays (each one's dtype, shape and bytes), so that
    two runs of one seed can be seen to serve the same queries."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}{a.shape};".encode())
        h.update(memoryview(a).cast("B"))
    return h.hexdigest()


def peaks_for(kind: str) -> Optional[Dict]:
    return read_json(os.path.join(HERE, "peaks.json")).get(kind)


def card_line(device) -> str:
    """The card's name, clocks and power limit, as nvidia-smi reads them."""
    if device.type != "cuda":
        return "no card"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=20,
        )
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read: {e!r}"


# ---------------------------------------------------------------------------
# the two loops
# ---------------------------------------------------------------------------


def _now() -> float:
    return time.perf_counter()


class Sampler:
    """A uniform sample, drawn from the seed, of the queries answered in the
    window (reservoir sampling), and the longest query answered (by the
    kind's ``row_sizes``).  Each call's answers are offered as they come and
    only the sampled rows are copied, so the window keeps no answer beyond
    its call."""

    def __init__(self, seed: int, size: int):
        from portbench import traffic

        self.rng = np.random.default_rng(traffic.sub_seed(seed, "sample"))
        self.size = size
        self.seen = 0
        self.slots: List = []  # ((key, row), labels, values)
        self.longest = (-1, None)

    def offer(self, key, sizes: np.ndarray, answer) -> None:
        """The answer (CSR, a row a query) to the queries of the call or
        request ``key``, whose sizes are ``sizes``."""
        n = len(sizes)
        t = np.arange(self.seen, self.seen + n)
        slot = np.where(t < self.size, t, self.rng.integers(0, t + 1))
        self.seen += n
        end = np.cumsum(answer.getnnz(axis=1))

        def row(r):
            a, b = (end[r - 1] if r else 0), end[r]
            return answer.indices[a:b].astype(np.int64), answer.data[a:b].copy()

        for r in np.nonzero(slot < self.size)[0].tolist():
            item = ((key, r), *row(r))
            if slot[r] == len(self.slots):
                self.slots.append(item)
            else:
                self.slots[slot[r]] = item
        r = int(np.argmax(sizes))
        if sizes[r] > self.longest[0]:
            self.longest = (int(sizes[r]), ((key, r), *row(r)))

    def items(self) -> List:
        keys = {it[0] for it in self.slots}
        extra = [self.longest[1]] if self.longest[1] is not None and self.longest[1][0] not in keys else []
        return self.slots + extra


def answered(out, n: int) -> bool:
    return out is not None and out.shape[0] == n


class ClosedLoop:
    """One client calling the program's batch predict back to back, each call
    a block of ``block`` queries cycled from a pool of ``pool``."""

    def __init__(self, cell: Cell, model, program, seed: int, device, log, seconds: float):
        from portbench import traffic

        kind, mix, cfg = cell.module(), cell.mix, cell.cfg
        n = int(mix["pool"])
        t = _now()
        lengths = traffic.permuted(traffic.quantile_lengths(n, mix["lengths"], cfg["mean_query_nnz"]), seed, "order")
        pool = kind.queries(model, n, lengths, mix, seed, device)
        t_pool = _now() - t
        t = _now()
        pool_digest = digest(kind.arrays(pool))
        t_digest = _now() - t
        self.blocks = [pool[a:b] for a, b in traffic.block_bounds(n, int(mix["block"]))]
        self.sizes = [kind.row_sizes(b) for b in self.blocks]
        self.batch = int(mix["batch_size"])
        self.trace_calls = int(mix["trace_calls"])
        self.program = program
        t = _now()
        for b in self.blocks:  # warm: every block's shapes (the first builds the program's layouts)
            program.predict(b)
        sizes = np.concatenate(self.sizes)
        log(f"pool: {n} queries in {t_pool!r} s, digest {pool_digest} in {t_digest!r} s, size mean "
            f"{int(sizes.sum()) / n!r}, max {int(sizes.max())}; {len(self.blocks)} blocks of {mix['block']}, "
            f"longest a block {[int(z.max()) for z in self.sizes]}; layouts and warm-up {_now() - t!r} s")

    def probe(self) -> int:
        """One more warm call, of the first block; returns the batches the
        benchmark counts in it."""
        self.program.predict(self.blocks[0])
        return -(-self.blocks[0].shape[0] // self.batch)

    def window(self, seconds: float, sampler: Sampler, slices=None) -> Dict:
        """Calls back to back until ``seconds`` have passed.  With ``slices``
        (a metrics and a gaps ``trace.Slice``), the third call on is traced
        for ``trace_calls`` calls, and the call after them with stacks."""
        rec = {"calls": [], "traced": [], "attempted": 0, "failed": 0, "answered": 0, "batches": 0}
        t0 = _now()
        i = 0

        def run(i0, n, keep):
            for j in range(i0, i0 + n):
                self._call(j, rec, sampler)
                keep.append(j)

        while True:
            if slices and i == 2:
                slices["metrics"].run(lambda i0=i: run(i0, self.trace_calls, rec["traced"]))
                i += self.trace_calls
                slices["gaps"].run(lambda i0=i: run(i0, 1, []))
                i += 1
            else:
                self._call(i, rec, sampler)
                i += 1
            if rec["calls"][-1][1] - t0 >= seconds and (not slices or rec["traced"]):
                break
        rec["window_s"] = rec["calls"][-1][1] - t0
        return rec

    def _call(self, i: int, rec: Dict, sampler: Sampler) -> None:
        b = i % len(self.blocks)
        X = self.blocks[b]
        start = _now()
        try:
            out = self.program.predict(X)
        except Exception as e:  # a failed call is counted, and its queries go unanswered
            print(f"portbench: call {i} failed: {e!r}", file=sys.stderr)
            out = None
        end = _now()
        rec["calls"].append((start, end))
        rec["attempted"] += X.shape[0]
        if answered(out, X.shape[0]):
            rec["answered"] += X.shape[0]
            rec["batches"] += -(-X.shape[0] // self.batch)
            sampler.offer(b, self.sizes[b], out)
        else:
            rec["failed"] += X.shape[0]

    def query(self, key, r: int):
        return self.blocks[key][r : r + 1]

    def end_to_end(self, rec: Dict, names) -> Dict[str, float]:
        return {"qps": rec["answered"] / rec["window_s"]}

    def service_s(self, rec: Dict) -> np.ndarray:
        return np.array([b - a for a, b in rec["calls"]])

    def traced_batches(self, rec: Dict):
        """The traced calls' queries, split into the program's batches."""
        out = []
        for j in rec["traced"]:
            block = self.blocks[j % len(self.blocks)]
            for s in range(0, block.shape[0], self.batch):
                out.append(block[s : s + self.batch])
        return out

    def report(self, rec: Dict, log) -> None:
        d = self.service_s(rec) * 1e3
        tenth = max(1, len(d) // 10)
        log(f"calls: {len(d)}, ms a call p50 {float(np.median(d))!r}, min {float(d.min())!r}, max {float(d.max())!r}; "
            f"first tenth mean {float(d[:tenth].mean())!r}, last tenth mean {float(d[-tenth:].mean())!r}")


class OpenLoop:
    """Open-loop arrivals at a fixed rate, served in arrival order by one
    session of the program; each request's latency runs from when it was due."""

    def __init__(self, cell: Cell, model, program, seed: int, device, log, seconds: float):
        from portbench import traffic

        kind, mix, cfg = cell.module(), cell.mix, cell.cfg
        self.rate = float(mix["rate_per_s"])
        n = max(1, int(round(self.rate * seconds)))
        law = mix["lengths"]
        lengths = traffic.permuted(traffic.quantile_lengths(n, law, cfg["mean_query_nnz"]), seed, "order")
        warm_n = int(mix["warm_requests"])
        warm_len = traffic.quantile_lengths(warm_n, law, cfg["mean_query_nnz"])
        both = kind.queries(model, n + warm_n, np.concatenate([lengths, warm_len]), mix, seed, device)
        self.requests = [both[i : i + 1] for i in range(n)]
        self.sizes = kind.row_sizes(both[:n])
        self.due = traffic.arrival_times(n, seconds, seed)
        self.seconds = seconds
        self.drain_s = float(mix["drain_s"])
        self.session = program.session(batch=int(mix["batch_size"]), cap=int(mix["session_cap"]))
        for i in range(n, n + warm_n):  # warm: the session's one shape
            self.session.predict(both[i : i + 1])
        self.warm_query = both[n : n + 1]
        log(f"open loop: {n} Poisson arrivals at {self.rate!r}/s, digest {digest(kind.arrays(both))}, "
            f"size mean {int(self.sizes.sum()) / n!r}, max {int(self.sizes.max())}; "
            f"session batch {mix['batch_size']}, cap {mix['session_cap']}; {warm_n} warm requests")
        self.trace_requests = int(mix["trace_requests"])
        self.gap_requests = int(mix["gap_requests"])

    def _serve(self, rec: Dict, sampler: Sampler, i0: int, i1: int) -> None:
        t0 = rec["t0"] + rec["shift"]
        for i in range(i0, i1):
            due = t0 + self.due[i]
            rec["due"][i] = due
            now = _now()
            if now < due:
                # the server polls for its next request: it never sleeps, so
                # its core stays awake and the request starts on time
                while _now() < due:
                    pass
                start = _now()
                rec["late"].append(start - due)
            else:
                start = now
            if start - t0 > self.seconds + self.drain_s:
                continue  # given up: never served
            try:
                out = self.session.predict(self.requests[i])
            except Exception as e:  # a failed request counts as missing
                print(f"portbench: request {i} failed: {e!r}", file=sys.stderr)
                out = None
            end = _now()
            rec["end"][i] = end
            rec["service"][i] = end - start
            rec["started"][i] = start
            if answered(out, 1):
                rec["ok"][i] = True
                sampler.offer(i, self.sizes[i : i + 1], out)

    def probe(self) -> int:
        """One more warm request; returns the batches it is (one)."""
        self.session.predict(self.warm_query)
        return 1

    def window(self, seconds: float, sampler: Sampler, slices=None) -> Dict:
        """Serves every request due in the window.  With ``slices``, the
        ``trace_requests`` from a quarter of the way in are traced, and the
        ``gap_requests`` after them with stacks."""
        n = len(self.requests)
        rec = {"ok": np.zeros(n, bool), "end": np.full(n, np.nan), "service": np.full(n, np.nan),
               "started": np.full(n, np.nan), "due": np.full(n, np.nan), "late": [], "traced": [], "shift": 0.0}
        rec["t0"] = _now() + 1e-3
        if not slices:
            self._serve(rec, sampler, 0, n)
        else:
            a = n // 4
            b = min(n, a + self.trace_requests)
            c = min(n, b + self.gap_requests)
            self._serve(rec, sampler, 0, a)
            # the profiler's start, stop and export hold the server up; later
            # requests are due that much later, so a traced run gives up none
            for name, (i0, i1) in (("metrics", (a, b)), ("gaps", (b, c))):
                t = _now()
                slices[name].run(lambda i0=i0, i1=i1: self._serve(rec, sampler, i0, i1))
                rec["shift"] += _now() - t - slices[name].summary["wall_s"]
            rec["traced"] = list(range(a, b))
            self._serve(rec, sampler, c, n)
        rec["window_s"] = self.seconds
        rec["attempted"] = n
        rec["answered"] = rec["batches"] = int(rec["ok"].sum())
        rec["failed"] = n - rec["answered"]
        return rec

    def latencies(self, rec: Dict) -> np.ndarray:
        """Seconds from due to answer; a request never answered counts as
        answered when the run gave up on it."""
        give_up = rec["t0"] + rec["shift"] + self.seconds + self.drain_s
        return np.where(rec["ok"], rec["end"], give_up) - rec["due"]

    def query(self, key, r: int):
        return self.requests[key][r : r + 1]

    def end_to_end(self, rec: Dict, names) -> Dict[str, float]:
        """Each declared ``p<q>_ms``: the q-th percentile of every request's latency."""
        lat = self.latencies(rec) * 1e3
        return {n: float(np.percentile(lat, float(m.group(1)))) for n in names if (m := re.fullmatch(r"p(\d+)_ms", n))}

    def service_s(self, rec: Dict) -> np.ndarray:
        return rec["service"][np.isfinite(rec["service"])]

    def traced_batches(self, rec: Dict):
        return [self.requests[i] for i in rec["traced"]]

    def report(self, rec: Dict, log) -> None:
        n = len(self.requests)
        ends = rec["end"][np.isfinite(rec["end"])]
        t0 = rec["t0"]
        backlog = int(np.sum((self.due < self.seconds) & ~(rec["started"] - t0 < self.seconds)))
        late = np.array(rec["late"]) * 1e3
        svc = self.service_s(rec) * 1e3
        span = float(ends.max() - t0) if len(ends) else 0.0
        log(f"open loop: offered {n / self.seconds!r}/s, achieved {len(ends) / max(span, 1e-9)!r}/s over {span!r} s; "
            f"backlog at the window's end {backlog}; drained {span - self.seconds!r} s after it")
        if len(late):
            log(f"generator lateness (requests that found the server idle: {len(late)}): mean {float(late.mean())!r} "
                f"ms, p99 {float(np.percentile(late, 99))!r} ms, max {float(late.max())!r} ms")
        if len(svc):
            log(f"service time in RealtimeSession.predict: p50 {float(np.percentile(svc, 50))!r} ms, "
                f"p95 {float(np.percentile(svc, 95))!r} ms, max {float(svc.max())!r} ms")


LOOPS = {"closed": ClosedLoop, "open": OpenLoop}


# ---------------------------------------------------------------------------
# the comparison that decides ``correct``
# ---------------------------------------------------------------------------


def compare(ref, Q, labels: np.ndarray, values: np.ndarray, bad_rows: np.ndarray, limits: Dict, batch: int,
            leaf_spread) -> Dict:
    """The numbers that decide ``correct``, over sampled queries Q with the
    program's answers ``labels``/``values`` (n, k), -1 padded; ``bad_rows``
    marks answers that are not k distinct labels in range.

    - value_err: the largest relative gap between a served score and the
      reference's value of the same label along its own path;
    - label_miss: labels of the reference's top-k that the program did not
      serve, over the queries whose beams no rounding within twice the
      value_err limit could change (``margin``);
    - missing: sampled answers that are not k distinct labels in range.

    Beside them, not compared: ``leaf_spread`` of each ``batch`` sampled
    queries, the leaf clusters their reference beams reach."""
    out = ref.beam_search(Q, keep_beams=True)
    true = ref.path_values(Q, labels)
    ok = (labels >= 0) & np.isfinite(true)
    err = np.abs(values.astype(np.float64) - true) / np.maximum(np.abs(true), 1e-300)
    value_err = float(err[ok].max(initial=0.0))
    tau = 2.0 * limits["value_err"]
    clear = (out["margin"] >= tau) & ~bad_rows
    miss = 0
    for r in np.nonzero(clear)[0]:
        want = out["labels"][r]
        miss += int(np.sum(~np.isin(want[want >= 0], labels[r])))
    last = out["beams"][-1]
    spread = [leaf_spread(last[s : s + batch], ref.children[-1].shape[0]) for s in range(0, len(last) - batch + 1, batch)]
    return {
        "leaf_spread": spread,
        "missing": int(bad_rows.sum()),
        "label_miss": miss,
        "value_err": value_err,
        "compared": int(len(labels)),
        "clear": int(clear.sum()),
        "margin_tau": tau,
    }


def answers_of(items, k: int, nr_labels: int):
    """(labels, values, bad) (n, k) arrays of the sampled answers, -1 padded;
    bad marks an answer that is not k distinct labels in range."""
    labels = np.full((len(items), k), -1, np.int64)
    values = np.zeros((len(items), k), np.float32)
    bad = np.zeros(len(items), bool)
    for i, (_, lab, val) in enumerate(items):
        m = min(len(lab), k)
        labels[i, :m], values[i, :m] = lab[:m], val[:m]
        if len(lab) != k or len(np.unique(lab)) != k or lab.min(initial=0) < 0 or lab.max(initial=0) >= nr_labels:
            bad[i] = True
    return labels, values, bad


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------


def check_batching(launches: int, batches: int, k1_levels: int, strict: bool, log) -> None:
    """The per-layer metrics count work in the benchmark's batches (the mix's
    ``batch_size``, the program's own) and K1 calls on the levels that the
    work model names.  A probe call's K1 launches (the program's sound
    counter) have to be its batches times those levels; where they are not,
    the program batches or lays out its levels otherwise, and the counts
    would be wrong: a traced run stops here."""
    want = batches * k1_levels
    if launches == want:
        log(f"batching: {launches} K1 launches in a probe call, {batches} batches x {k1_levels} K1 levels, as counted")
        return
    msg = (f"the program made {launches} K1 launches in a probe call where the benchmark counts {batches} batches "
           f"x {k1_levels} K1 levels = {want}: its batch size or its layout rule is not the one the work counters "
           f"assume (the mix's batch_size, models/<model>_work.py)")
    if strict:
        raise RuntimeError(msg)
    log("portbench: " + msg)


def run_cell(
    name: str,
    seed: int,
    seconds: float,
    trace: bool,
    device,
    t_start: float,
    *,
    wire: str = "float32",
    root: str = ROOT,
    log: Callable[[str], None] = print,
) -> Dict:
    """One run of cell ``name``; returns the result line's object, with the
    comparison's numbers under ``checks``.  ``wire`` "float16" runs the
    control (the port's lower-precision query wire) in the program's place."""
    import torch

    cell = Cell(name, root)
    kind, reference, work = cell.module(), cell.module("_reference"), cell.module("_work")
    cfg = cell.cfg
    log(f"portbench: cell {name}, config {cell.entry['config']}, traffic {cell.entry['traffic']}, seed {seed}, "
        f"window {seconds!r} s, trace {int(trace)}, wire {wire}")
    log(f"card: {card_line(device)}")
    from pecos_tpu_torch.ops.intersect import intersect_scores

    t = _now()
    t_before = t - t_start
    model = kind.Model(cfg, seed, device)
    t_model = _now() - t
    program = kind.Program(model, device, wire=wire)
    loop = LOOPS[cell.mix["loop"]]  # (the window's length sizes an open loop's arrivals)
    t = _now()
    runner = loop(cell, model, program, seed, device, log, seconds)
    launches0 = intersect_scores.launches
    batches = runner.probe()
    log(f"set-up parts: start, imports and card {t_before!r} s, model from the seed {t_model!r} s, "
        f"queries, the program's layouts and warm-up {_now() - t!r} s")
    if device.type == "cuda":  # (K1 launches only on the card; the CPU runs its plain version)
        check_batching(intersect_scores.launches - launches0, batches, sum(work.k1_levels(model.D, model.sizes)),
                       trace, log)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = _now() - t_start
    from portbench import trace as tracing

    slices = {"metrics": tracing.Slice(device), "gaps": tracing.Slice(device, stacks=True)} if trace else None
    sampler = Sampler(seed, int(cfg["compare_sample"]))
    launches0 = intersect_scores.launches
    rec = runner.window(seconds, sampler, slices)
    launches = intersect_scores.launches - launches0
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    e2e = runner.end_to_end(rec, [m["name"] for m in cell.end_to_end])
    e2e["setup_s"] = setup_s
    attempted, failed = rec["attempted"], rec["failed"]
    log(f"set-up {setup_s!r} s; window {rec['window_s']!r} s; attempted {attempted}, failed {failed}; "
        f"peak device memory {peak} bytes since set-up; K1 launches {launches}, "
        f"{launches / max(rec['batches'], 1)!r} a batch (intersect_scores.launches)")
    log("end to end: " + ", ".join(f"{k} {v!r}" for k, v in sorted(e2e.items())))
    runner.report(rec, log)
    service = runner.service_s(rec)
    traced_queries = runner.traced_batches(rec) if trace else []
    items = sampler.items()
    Q = kind.stack([runner.query(*key) for key, _, _ in items]) if items else None
    labels, values, bad = answers_of(items, int(cfg["only_topk"]), model.sizes[-1])
    # the window has closed: free the program's state before the reference runs
    del runner, program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = _now()
    ref = reference.build(model, cfg, device)
    if Q is not None:
        numbers = compare(ref, Q, labels, values, bad, cell.limits, SPREAD_QUERIES, work.leaf_spread)
    else:
        numbers = {"missing": 0, "label_miss": 0, "value_err": 0.0, "compared": 0, "clear": 0,
                   "margin_tau": 2.0 * cell.limits["value_err"], "leaf_spread": []}
    numbers["failed"] = failed
    log(f"reference: {numbers['compared']} sampled answers compared ({numbers['clear']} with every beam cut clear "
        f"of {numbers['margin_tau']!r}) in {_now() - t_ref!r} s")
    if numbers["leaf_spread"]:
        log(f"leaf clusters the reference beams of {SPREAD_QUERIES} sampled queries reach: "
            + ", ".join(f"{sp['distinct']} (uniform beams {sp['uniform']:.1f})" for sp in numbers["leaf_spread"]))
    dev_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": int(cell.entry["chips"]),
        "memory_peak_bytes": peak,
    }
    result: Dict = {"correct": None, "attempted": attempted, "failed": failed}
    if trace:
        summary, gaps = slices["metrics"].summary, slices["gaps"].summary
        peaks = peaks_for(dev_info["kind"])
        ctx = {
            "trace": summary if device.type == "cuda" else None,
            "batches": len(traced_queries),
            "service_s": service,
            "peaks": peaks,
            "k1_kernel": K1_KERNEL,
            "work": None,
        }
        if peaks is not None and traced_queries:
            ctx["work"] = work.traced(ref, model, traced_queries, cfg, peaks)
            log(f"traced work: K1 {ctx['work']['k1']}, whole predict {ctx['work']['predict']}; per level, "
                f"candidates and distinct rows summed over batches: {ctx['work']['levels']}; leaf clusters each "
                f"traced batch's beams reach: "
                + ", ".join(f"{sp['distinct']} (uniform {sp['uniform']:.1f})" for sp in ctx["work"]["leaf_spread"]))
        log(f"traced slice: wall {summary['wall_s']!r} s, device busy {summary['busy_s']!r} s, "
            f"{len(summary['kernels'])} kernels, {ctx['batches']} batches; "
            f"peaks {peaks}")
        metrics = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"], root)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if device.type == "cuda":
            dev_info["busy_s"] = summary["busy_s"]
            dev_info["window_s"] = summary["wall_s"]
            result["breakdown"] = {"device_ops": summary["device_ops"],
                                   "idle_gaps": (gaps or summary)["idle_gaps"]}
    else:
        metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]} for m in cell.end_to_end}
    result["metrics"] = metrics
    result["device"] = dev_info
    checks = {k: {"value": numbers[k], "limit": cell.limits[k]} for k in ("failed", "missing", "label_miss", "value_err")}
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    return result

