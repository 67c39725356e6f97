"""Helpers that the metric readers under `metrics/` share: what the
window completed, the least time of that work (`costs`), and the
program's spans and counters over the window."""
from __future__ import annotations

FAILED_MS = 1e6          # a failed request's latency: over any limit
COLLECTION = "mem"       # the one collection the harness serves


class Counters(dict):
    """The window's difference of each key of `MemoryService.counters()`;
    called with a key, that difference, 0 where the key is absent."""

    def __call__(self, name: str) -> float:
        return self.get(name, 0)


def in_window(ctx, items):
    """Requests or writes that completed inside the window."""
    return [x for x in items if x.ok and ctx.t0 <= x.t_done <= ctx.t1]


def query_least_s(ctx) -> float:
    return sum(ctx.costs.query_s(ctx.cfg, ctx.spill, r.b, r.path)
               for r in in_window(ctx, ctx.requests))


def write_least_s(ctx) -> float:
    total = 0.0
    for w in in_window(ctx, ctx.writes):
        fn = ctx.costs.insert_s if w.kind == "insert" else ctx.costs.delete_s
        total += fn(ctx.cfg, ctx.spill, w.rows)
    total += ctx.rebuilds * ctx.costs.rebuild_s(ctx.cfg, ctx.spill,
                                               ctx.live_rows)
    return total


def exec_ms(ctx, kind: str):
    """Mean execution time (latency less queue wait) of the window's
    scheduler tasks of `kind`; None where none completed."""
    n, wait_s, lat_s = ctx.delta(kind)
    return 1e3 * (lat_s - wait_s) / n if n else None


def idle_pct(ctx):
    """Share of the traced window with no device work, in %."""
    if ctx.trace is None or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])


def per_span_ms(ctx, name: str, key: str):
    """Milliseconds of `key` (`host_s` or `device_s`) per range of the
    program's span `name` in the traced window (`ctx.spans`, `lib/spans.py`);
    None untraced or where the span saw no range."""
    if ctx.spans is None:
        return None
    s = ctx.spans["spans"].get(name)
    return 1e3 * s[key] / s["n"] if s and s["n"] else None
