"""moe_mfu.textbatch: the whole predict's share of the card's roofline in the
traced slice: the least time its work needs (the sparse-expert encoder's
operations at the bfloat16 peak, then the ranker's rows, queries and top-k,
counted by models/<model>_work.py from the reference's tokens and beam; each
part by its larger bound) over the slice's wall time.  None where the work
has no expert layers; raises above 100%: the work would be counted too high
or the wall would leave out work."""


def read(ctx):
    t, work = ctx.get("trace"), ctx.get("work")
    if t is None or work is None or "moe" not in work or not t["wall_s"] or not t["busy_s"]:
        return None
    share = 100.0 * work["predict"]["seconds"] / t["wall_s"]
    if share > 100.0:
        raise RuntimeError(f"moe_mfu {share!r}% over 100%: {work['predict']['seconds']!r} s of work in "
                           f"{t['wall_s']!r} s")
    return share
