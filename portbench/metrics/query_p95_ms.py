"""95th percentile of every recall request sent in the window, from its
send to its answer on the host; a failed request counts as over any
limit.  In a closed loop at the card's capacity the tail moves with the
rate (sessions over latency), so it is a per-layer reading there."""
import numpy as np

from portbench.lib.readers import FAILED_MS


def read(ctx):
    if not ctx.requests:
        return None
    lat = [1e3 * (r.t_done - r.t_sub) if r.ok else FAILED_MS
           for r in ctx.requests]
    return float(np.percentile(lat, 95))
