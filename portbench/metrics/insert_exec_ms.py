"""Mean execution time (latency less queue wait) of the window's insert
tasks: the writer lock, the assignment, the copy-on-write swap."""
from portbench.lib.readers import exec_ms


def read(ctx):
    return exec_ms(ctx, "insert")
