"""host_ms.batch: host milliseconds a 1,024-query batch in the traced slice,
the slice's wall time less the time the card was busy, over its batches."""


def read(ctx):
    t = ctx.get("trace")
    if t is None or not ctx.get("batches"):
        return None
    return (t["wall_s"] - t["busy_s"]) * 1e3 / ctx["batches"]
