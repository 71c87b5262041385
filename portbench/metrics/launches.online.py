"""launches.online: CUDA kernels in the traced slice over the requests it
served (an exact count from the device trace)."""


def read(ctx):
    t = ctx.get("trace")
    if t is None or not ctx.get("batches") or not t["kernels"]:
        return None
    return len(t["kernels"]) / ctx["batches"]
