"""What the program's own spans and counters read, for the per-layer metrics
in ``metrics/`` that come from them.

The registry (``pecos_tpu_torch.utils.profile_util``) covers the whole
process: one run of one cell.  So a value covers the set-up's warm and probe
calls too (about 4% of a traced run's batches, and the first calls' one-time
costs), the window, and the traced slices (the stack-sampled call about 0.4%
of the batches).  Each reader returns None where the program records no such
span or counter, as a program without the registry does."""

from typing import Dict, Optional


def registry() -> Optional[Dict]:
    """The program's registry, ``{"spans": {name: {"s", "n"}}, "counters":
    {name: int}}``, or None where the program keeps none."""
    from pecos_tpu_torch.utils import profile_util

    if not hasattr(profile_util, "snapshot"):
        return None
    return profile_util.snapshot()


def span_s(name: str) -> Optional[float]:
    """Host seconds summed over span ``name``, or None."""
    snap = registry()
    span = snap and snap["spans"].get(name)
    return span["s"] if span else None


def ms_per_batch(name: str) -> Optional[float]:
    """Host milliseconds in span ``name`` over the counter ``pecos.batches``, or None."""
    snap = registry()
    span = snap and snap["spans"].get(name)
    batches = snap and snap["counters"].get("pecos.batches")
    if not span or not batches:
        return None
    return 1e3 * span["s"] / batches


def padded_share() -> Optional[float]:
    """Percent of the slots of the padded query blocks the walk reads that
    are padding, 100 x (1 - ``pecos.query_nnz`` / ``pecos.query_slots``), or
    None."""
    snap = registry()
    slots = snap and snap["counters"].get("pecos.query_slots")
    if not slots:
        return None
    return 100.0 * (1.0 - snap["counters"].get("pecos.query_nnz", 0) / slots)
