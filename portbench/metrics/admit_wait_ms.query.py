"""Mean time a query's `submit` waited for a slot of the scheduler's
submission window before it was queued (`sched.query.admit_wait_s` per
`sched.query.n`, the window's differences of `MemoryService.counters()`)."""


def read(ctx):
    n = ctx.counters("sched.query.n")
    return 1e3 * ctx.counters("sched.query.admit_wait_s") / n if n else None
