"""Mean scheduler queue wait of the window's query tasks (the scheduler's
aggregates, differenced across the window)."""


def read(ctx):
    n, wait_s, _ = ctx.delta("query")
    return 1e3 * wait_s / n if n else None
