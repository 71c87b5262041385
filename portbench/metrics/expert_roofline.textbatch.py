"""expert_roofline.textbatch: the grouped GEMM's share of its roofline in the
traced slice: the least time its launches need (each launch's operations at
the card's bfloat16 peak, or its bytes at the HBM peak if that is larger,
counted by models/<model>_work.py from the reference's real tokens: one pair
a real token and expert, two launches an expert layer and forward) over the
time the trace gives the kernel (the port's ``grouped_gemm.KERNEL_NAME``).
None where the trace holds no such kernel or the work has no expert layers;
raises where the trace's launches are not the work's, and above 100%: the
operations would be counted too high or the time would leave out work."""


def read(ctx):
    t, work = ctx.get("trace"), ctx.get("work")
    if t is None or work is None or "moe" not in work:
        return None
    try:
        from pecos_tpu_torch.ops.grouped_gemm import KERNEL_NAME
    except ImportError:
        return None
    times = [d for name, d in t["kernels"] if KERNEL_NAME in name]
    if not times:
        return None
    if len(times) != work["moe"]["calls"]:
        raise ValueError(f"the trace holds {len(times)} grouped GEMM kernels where the work counts "
                         f"{work['moe']['calls']} launches")
    share = 100.0 * work["moe"]["seconds"] / sum(times)
    if share > 100.0:
        raise RuntimeError(f"expert_roofline {share!r}% over 100%: {len(times)} launches in {sum(times)!r} s")
    return share
