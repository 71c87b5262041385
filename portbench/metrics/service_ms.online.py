"""service_ms.online: median milliseconds a request spent inside
RealtimeSession.predict over the window (host clock; queueing excluded)."""

import numpy as np


def read(ctx):
    s = ctx.get("service_s")
    if s is None or not len(s):
        return None
    return float(np.median(s)) * 1e3
