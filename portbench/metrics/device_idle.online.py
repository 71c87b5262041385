"""device_idle.online: percent of the traced slice's wall time in which no
operation ran on the card."""


def read(ctx):
    t = ctx.get("trace")
    if t is None or not t["wall_s"] or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["wall_s"])
