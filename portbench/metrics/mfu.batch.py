"""mfu.batch: the whole predict's share of the card's roofline in the traced
slice: the least time its work needs (every level's candidate rows, the
queries and the top-k, counted by models/<model>_work.py from the
reference's beam; bytes or float32 operations, whichever bound is larger)
over the slice's wall time."""


def read(ctx):
    t, work = ctx.get("trace"), ctx.get("work")
    if t is None or work is None or not t["wall_s"] or not t["busy_s"]:
        return None
    return 100.0 * work["predict"]["seconds"] / t["wall_s"]
