"""Memory reporting for phase-boundary logs (the port of ``pecos_tpu/utils/profile_util.py``),
and the program's own spans and counters.

``span(name)`` times a block of the program on the host clock and ``count(name,
n)`` adds to a counter, both into one in-memory registry of the process that
``snapshot()`` copies out and ``reset()`` zeroes.  While a ``torch.profiler``
is recording, a span also enters ``torch.profiler.record_function(name)``, so
it lands as a ``user_annotation`` event on the profiler's timeline beside the
device's kernels and copies; spans nest by enclosure on one thread, as the
profiler's events do.  With no profiler running a span costs one check of the
profiler's state, a pair of clock reads and a dict add.  The registry's adds
run under the interpreter lock without one of their own: exact where one
thread records, and a concurrent add to the same name may be lost.

``device_span(name, device)`` times a block on the card: two CUDA events on
the device's current stream, with no synchronisation of its own.  Its
microseconds reach counter ``name`` when ``settle()`` finds the second event
complete, so call ``settle()`` after a fetch that has waited for the card.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List

import torch

# name -> [seconds, calls]
_SPANS: Dict[str, list] = {}
_COUNTERS: Dict[str, int] = {}
# (counter name, start event, end event) of device spans not settled yet
_PENDING: List[tuple] = []


class span:
    """Context manager: adds the block's host seconds and one call to span
    ``name``, also when the block raises; inside a recording
    ``torch.profiler`` it is a ``record_function(name)`` range as well."""

    __slots__ = ("name", "_t0", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        # record_function costs microseconds even with no profiler running:
        # enter it only while one records
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        else:
            self._range = None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        dt = time.perf_counter() - self._t0
        rec = _SPANS.get(self.name)
        if rec is None:
            rec = _SPANS[self.name] = [0.0, 0]
        rec[0] += dt
        rec[1] += 1
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


class device_span:
    """Context manager: CUDA events before and after the block on
    ``device``'s current stream; ``settle()`` adds the microseconds between
    them to counter ``name``.  ``end`` is the second event once the block
    has closed, so a caller can ask whether the card has reached it.  On a
    device other than a CUDA one it records nothing and ``end`` is None."""

    __slots__ = ("name", "device", "_start", "end")

    def __init__(self, name: str, device: torch.device):
        self.name, self.device = name, device

    def __enter__(self) -> "device_span":
        self._start = self.end = None
        if self.device.type == "cuda":
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc) -> bool:
        if self._start is not None:
            self.end = torch.cuda.Event(enable_timing=True)
            self.end.record(torch.cuda.current_stream(self.device))
            _PENDING.append((self.name, self._start, self.end))
        return False


def settle() -> None:
    """Add each device span whose end event has completed to its counter, in
    whole microseconds; the others stay pending.  It asks the events without
    waiting for them."""
    left = []
    for name, start, end in _PENDING:
        if end.query():
            count(name, round(1e3 * start.elapsed_time(end)))
        else:
            left.append((name, start, end))
    _PENDING[:] = left


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    _COUNTERS[name] = _COUNTERS.get(name, 0) + int(n)


def snapshot() -> Dict[str, Dict]:
    """A copy of the registry: ``{"spans": {name: {"s": seconds, "n": calls}},
    "counters": {name: int}}``."""
    return {
        "spans": {k: {"s": v[0], "n": v[1]} for k, v in _SPANS.items()},
        "counters": dict(_COUNTERS),
    }


def reset() -> None:
    """Zero the registry."""
    _SPANS.clear()
    _COUNTERS.clear()
    _PENDING.clear()


class MemInfo(object):
    @staticmethod
    def mem_info() -> str:
        """The process's resident set size, as ``mem: rss=<GB>GB``."""
        try:
            import psutil

            rss = psutil.Process(os.getpid()).memory_info().rss
        except ImportError:
            try:
                with open("/proc/self/statm") as f:
                    rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
            except OSError:
                return "mem_info unavailable"
        return f"mem: rss={rss / 2**30:.2f}GB"

    @staticmethod
    def device_mem_info() -> str:
        """Memory in use and total of each CUDA device, or ``no device stats``."""
        if not torch.cuda.is_available():
            return "no device stats"
        parts = []
        for i in range(torch.cuda.device_count()):
            free, total = torch.cuda.mem_get_info(i)
            parts.append(f"cuda:{i}: {(total - free) / 2**30:.2f}/{total / 2**30:.2f}GB")
        return "; ".join(parts)
