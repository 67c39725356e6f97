"""Least time of the window's queries (`costs`) over the device's busy
time in the traced window, in %: every kernel of a cell without writes is
query work."""
from portbench.lib.readers import query_least_s


def read(ctx):
    if ctx.trace is None or ctx.trace["busy_s"] <= 0:
        return None
    return 100.0 * query_least_s(ctx) / ctx.trace["busy_s"]
