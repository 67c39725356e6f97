"""Share of the traced window in which nothing ran on the device, in %,
in a cell without writes (it moves the query rate)."""
from portbench.lib.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
