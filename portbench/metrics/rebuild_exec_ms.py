"""Mean execution time of the window's rebuild tasks, which maintenance
scheduled (re-cluster off the writer lock, delta replay, swap)."""
from portbench.lib.readers import exec_ms


def read(ctx):
    return exec_ms(ctx, "rebuild")
