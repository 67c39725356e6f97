"""Rows whose insert was acknowledged inside the window, per second."""


def read(ctx):
    ins = [w for w in ctx.writes if w.kind == "insert"]
    if not ins:
        return None
    return sum(w.rows for w in ins if w.ok and w.t_done <= ctx.t1) / ctx.seconds
