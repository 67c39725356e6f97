"""Least time of every query completed in the window over the window's
length, in %: the whole window's share of the chip's peak."""
from portbench.lib.readers import query_least_s


def read(ctx):
    return 100.0 * query_least_s(ctx) / ctx.seconds
