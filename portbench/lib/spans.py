"""The traced window by the program's spans, from `torch.profiler` events.

The port opens a profiler range named ``ame.<layer>.<phase>`` around each
phase of its work while a profiler records (`repro_torch.core.spans`).
`reduce` reads the same events as `devtrace.reduce`, with its busy time,
its clipping to the window and its rule for the benchmark's clients, and
gives per span name:

- `n` and `host_s`: the span's ranges and their summed host time;
- `device_s`: device time whose launch lies inside that span as the
  innermost ``ame.`` range on the launching thread (the span that caused a
  span encloses it on its thread);
- `idle_s`: the idle gaps that such a launch ends.

Device time and gaps with no ``ame.`` range around their launch go to
`unspanned`.  A host event's thread is its `device_resource_id()` (the
system thread the profiler saw), not its `start_thread_id()`: PyTorch files
a launch that no aten operator encloses (each hand-written kernel's, made
through ctypes) under the profiling thread's id, so by that id it would
leave the worker thread whose span encloses it.  Each gap is labelled ``<innermost ame. span>|<devtrace's
label>`` (the outermost host operator other than the spans, or the launch
call), or devtrace's label alone where no span encloses the launch.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

from portbench.lib.devtrace import CLIENT, TOP, _HostOps, _is_launch, _union

PREFIX = "ame."
LABEL = 64                     # characters of a gap's label


def _thread(e) -> int:
    """The system thread of a host event (its start thread id where this
    PyTorch gives no resource id)."""
    rid = getattr(e, "device_resource_id", None)
    return rid() if rid is not None else e.start_thread_id()


def _change_points(rs: List[Tuple[int, int, str]]):
    """(times, names): from each time on, the innermost of the ranges `rs`
    of one thread (ranges on one thread nest), None outside them all."""
    times: List[int] = []
    names: List[Optional[str]] = []
    stack: List[Tuple[int, str]] = []
    for s, e, name in sorted(rs, key=lambda x: (x[0], -x[1])) + [
            (float("inf"), 0, None)]:
        while stack and stack[-1][0] <= s:
            end, _ = stack.pop()
            times.append(end)
            names.append(stack[-1][1] if stack else None)
        if name is not None:
            stack.append((e, name))
            times.append(s)
            names.append(name)
    return times, names


class _Innermost:
    """Innermost range per thread, found by time."""

    def __init__(self, ranges: Dict[int, List[Tuple[int, int, str]]]):
        self.points = {tid: _change_points(rs) for tid, rs in ranges.items()}

    def at(self, tid: int, t: int) -> Optional[str]:
        times, names = self.points.get(tid, ([], []))
        i = bisect.bisect_right(times, t) - 1
        return names[i] if i >= 0 else None


def reduce(events, window_s: float, lo: Optional[int] = None) -> dict:
    """The spans table of the traced window [lo, lo + window_s]."""
    dev_type = torch.autograd.DeviceType.CUDA
    device: List[Tuple[int, int, int]] = []
    launches: Dict[int, Tuple[int, int, str]] = {}
    ops: Dict[int, List[Tuple[int, int, str]]] = defaultdict(list)
    ranges: Dict[int, List[Tuple[int, int, str]]] = defaultdict(list)
    table: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"n": 0, "host_s": 0.0, "device_s": 0.0, "idle_s": 0.0})
    for e in events:
        name = e.name()
        s = e.start_ns()
        end = s + e.duration_ns()
        if e.device_type() == dev_type:
            if e.is_user_annotation():
                continue
            if lo is not None:
                s, end = max(s, lo), min(end, lo + int(window_s * 1e9))
                if end <= s:
                    continue
            device.append((s, end, e.correlation_id()))
        elif _is_launch(name):
            launches[e.correlation_id()] = (_thread(e), s, name)
        elif name.startswith(PREFIX):
            ranges[_thread(e)].append((s, end, name))
            table[name]["n"] += 1
            table[name]["host_s"] += (end - s) / 1e9
        else:
            ops[_thread(e)].append((s, end, name))
    host, inner = _HostOps(ops), _Innermost(ranges)

    def origin(corr: int):
        """(innermost span or None, devtrace's label) of a launch."""
        if corr not in launches:
            return None, "unattributed"
        tid, t, call = launches[corr]
        return inner.at(tid, t), host.at(tid, t) or call

    device = [d for d in device if origin(d[2])[1] != CLIENT]
    by_span: Dict[Optional[str], List[Tuple[int, int]]] = defaultdict(list)
    for s, e, corr in device:
        by_span[origin(corr)[0]].append((s, e))
    for name, intervals in by_span.items():
        if name is not None:
            table[name]["device_s"] = sum(
                e - s for s, e in _union(intervals)) / 1e9
    unspanned = {"device_s": sum(e - s for s, e in _union(
        by_span.get(None, []))) / 1e9, "idle_s": 0.0}
    busy = _union([(s, e) for s, e, _ in device])
    first_of = {}
    for s, _, corr in device:
        first_of.setdefault(s, corr)
    gaps: Dict[str, float] = defaultdict(float)
    for (_, prev_end), (nxt, _) in zip(busy, busy[1:]):
        name, label = origin(first_of[nxt])
        gap = (nxt - prev_end) / 1e9
        if name is None:
            unspanned["idle_s"] += gap
        else:
            table[name]["idle_s"] += gap
            label = f"{name}|{label}"
        gaps[label[:LABEL]] += gap
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": sum(e - s for s, e in busy) / 1e9,
            "window_s": window_s, "spans": dict(table),
            "unspanned": unspanned, "idle_gaps": [list(g) for g in idle]}
