"""k1_roofline.batch: K1's share of its roofline in the traced slice: the
least time its calls need (bytes at the peak bandwidth, or float32
multiply-adds at the peak rate if that is larger, counted by
models/<model>_work.py from the reference's beam) over the time the trace
gives K1's kernel.  Nothing is read where the trace holds no K1 kernel (K1
is off the path); where it holds another number of K1 kernels than the work
counts calls, the program batches or lays out its levels otherwise than the
work counters assume, and the reader raises rather than read a wrong share."""


def read(ctx):
    t, work = ctx.get("trace"), ctx.get("work")
    if t is None or work is None:
        return None
    times = [d for name, d in t["kernels"] if ctx["k1_kernel"] in name]
    if not times:
        return None
    if len(times) != work["k1"]["calls"]:
        raise ValueError(f"the trace holds {len(times)} K1 kernels where the work counts {work['k1']['calls']} calls")
    return 100.0 * work["k1"]["seconds"] / sum(times)
