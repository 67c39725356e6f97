"""Share of the traced window in which nothing ran on the device, in %,
in a cell that writes (it moves the insert rate: the writes queue on the
same stream as the queries)."""
from portbench.lib.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
