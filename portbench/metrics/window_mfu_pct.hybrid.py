"""Least time of every operation completed in the window (queries,
inserts, deletes, rebuilds) over the window's length, in %."""
from portbench.lib.readers import query_least_s, write_least_s


def read(ctx):
    if not ctx.writes:
        return None
    return 100.0 * (query_least_s(ctx) + write_least_s(ctx)) / ctx.seconds
