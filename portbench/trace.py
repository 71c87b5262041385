"""The traced slice: ``torch.profiler`` over a short steady part of a run,
reduced to what the per-layer metrics read.

The profile is exported as a Chrome trace into ``TMPDIR``, read back and
deleted; only a short slice is traced, so the file stays a few MB.  From it:

- device operations: kernels, copies and sets on the card (``cat`` kernel,
  gpu_memcpy, gpu_memset), with names and intervals;
- busy seconds: the length of the union of their intervals;
- host operations (``cpu_op``, ``user_annotation``), which name what the host
  was doing while the card sat idle.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
TOP = 10


def union_length(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(total length, merged intervals) of (start, end) pairs."""
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return sum(b - a for a, b in merged), merged


def summarize(events: List[Dict], wall_s: float) -> Dict[str, object]:
    """What the metrics read from a Chrome trace's events (times in us)."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    kernels = [(e["name"], float(e["dur"]) * 1e-6) for e in dev if e["cat"] == "kernel"]
    busy_us, merged = union_length([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev])
    by_name: Dict[str, float] = defaultdict(float)
    for e in dev:
        by_name[e["name"]] += float(e["dur"]) * 1e-6
    gaps: Dict[str, float] = defaultdict(float)
    if host:
        # the thread that issued most host operations: the one driving the card
        counts: Dict[object, int] = defaultdict(int)
        for h in host:
            counts[h.get("tid")] += 1
        main = max(counts, key=counts.get)
        host = [h for h in host if h.get("tid") == main]
    h_start = np.array([float(h["ts"]) for h in host])
    h_end = h_start + np.array([float(h["dur"]) for h in host])
    h_dur = h_end - h_start
    for g0 in range(0, max(len(merged) - 1, 0), 256):
        pairs = list(zip(merged[g0 : g0 + 257][:-1], merged[g0 : g0 + 257][1:]))
        mids = np.array([(a[1] + b[0]) / 2 for a, b in pairs])
        over = (h_start[None, :] <= mids[:, None]) & (mids[:, None] <= h_end[None, :])
        inner = np.where(over, h_dur[None, :], np.inf).argmin(axis=1) if len(host) else None
        for i, (a, b) in enumerate(pairs):
            name = host[inner[i]]["name"] if len(host) and over[i, inner[i]] else "host, no traced operation"
            gaps[name] += (b[0] - a[1]) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {
        "wall_s": wall_s,
        "busy_s": busy_us * 1e-6,
        "kernels": kernels,
        "device_ops": top(by_name),
        "idle_gaps": top(gaps),
    }


class Slice:
    """``run(fn)`` calls ``fn`` under torch.profiler (host and device
    activity) between two synchronisations of the card, then exports, reads
    and deletes its trace (before any other profile starts: a second profile
    clears the first's events) into ``summary``.  With ``stacks`` the host's
    Python frames are recorded too, which names idle gaps by the program's
    own functions but slows the host: such a slice names gaps and is not
    timed."""

    def __init__(self, device, stacks: bool = False):
        self.device = device
        self.stacks = stacks
        self.summary = None

    def run(self, fn: Callable[[], object]):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        sync()
        with profile(activities=acts, with_stack=self.stacks) as prof:
            t0 = time.perf_counter()
            out = fn()
            sync()
            wall = time.perf_counter() - t0
        fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.summary = summarize(events, wall)
        return out
