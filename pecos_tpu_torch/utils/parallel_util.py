"""Host-side multiprocess map (the port of ``pecos_tpu/utils/parallel_util.py``):
for I/O and preprocessing work (corpus parsing, shard writing) where a
process fan-out pays; device work stays on the card."""

from __future__ import annotations

import multiprocessing as mp
from typing import Callable, Iterable, List, Optional


def run_parallel(fn: Callable, items: Iterable, num_workers: Optional[int] = None, chunksize: int = 1) -> List:
    """``[fn(x) for x in items]`` over a spawn-context process pool; serial
    with at most one worker or one item.  ``fn`` must be picklable by import
    path when a pool runs."""
    items = list(items)
    if num_workers is None:
        num_workers = mp.cpu_count()
    if num_workers <= 1 or len(items) <= 1:
        return [fn(x) for x in items]
    with mp.get_context("spawn").Pool(num_workers) as pool:
        return pool.map(fn, items, chunksize=chunksize)
