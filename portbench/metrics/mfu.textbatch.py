"""mfu.textbatch: the whole predict's share of the card's roofline in the
traced slice: the least time its work needs (the encoder's operations at the
float32 peak, then the ranker's rows, queries and top-k, counted by
models/<model>_work.py from the reference's beam; each part by its larger
bound) over the slice's wall time."""


def read(ctx):
    t, work = ctx.get("trace"), ctx.get("work")
    if t is None or work is None or "encoder" not in work or not t["wall_s"] or not t["busy_s"]:
        return None
    return 100.0 * work["predict"]["seconds"] / t["wall_s"]
