"""Query vectors answered inside the window, per second of window."""


def read(ctx):
    done = [r for r in ctx.requests if r.ok and r.t_done <= ctx.t1]
    return sum(r.b for r in done) / ctx.seconds
