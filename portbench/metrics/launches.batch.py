"""launches.batch: CUDA kernels in the traced slice over its 1,024-query
batches (an exact count from the device trace)."""


def read(ctx):
    t = ctx.get("trace")
    if t is None or not ctx.get("batches") or not t["kernels"]:
        return None
    return len(t["kernels"]) / ctx["batches"]
