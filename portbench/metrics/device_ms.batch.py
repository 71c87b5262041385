"""device_ms.batch: milliseconds the card was busy (the union of its
kernels', copies' and sets' intervals) over the traced slice's batches."""


def read(ctx):
    t = ctx.get("trace")
    if t is None or not ctx.get("batches") or not t["busy_s"]:
        return None
    return t["busy_s"] * 1e3 / ctx["batches"]
