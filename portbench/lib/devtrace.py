"""The traced run's device numbers, from `torch.profiler` over the window.

Busy time is the union of every device interval (kernels, copies, sets):
the port launches on one stream, but the union is right even if it did
not.  Each idle gap is named by what the host was doing: the outermost
host operator, on any thread, that launched the device work which ended
the gap.  The host's own operators are recorded on every thread where this
PyTorch can (`profile_all_threads`); where it cannot, a gap is named by
the launch call itself.  The profiler slows the host, so an idle share is
only compared with another traced run's.

The benchmark's clients are not the program: device work launched inside
a `CLIENT` range (the sessions' queries, the writers' rows) is left out of
the busy time and of the device operations, and reported apart as
`client_s`.  The device's side of a profiler range (a user annotation) is
no device work either.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

TOP = 10
CLIENT = "portbench.client"


def start():
    """Start the profiler; returns (profiler, host start time)."""
    from torch.profiler import ProfilerActivity, profile
    kw = {}
    try:
        from torch._C._profiler import _ExperimentalConfig
        kw["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    except (ImportError, TypeError):
        pass
    prof = profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA], **kw)
    prof.start()
    return prof, time.perf_counter()


def stop(handle) -> dict:
    """Stop the profiler and reduce its events: busy_s, window_s and the
    breakdown (device operations and idle gaps, the longest ten of each),
    and under `spans` the same events by the program's spans
    (`lib/spans.py`)."""
    from portbench.lib import spans     # it imports this module's helpers
    prof, t0 = handle
    window_s = time.perf_counter() - t0
    prof.stop()
    res = prof.profiler.kineto_results
    lo = res.trace_start_ns() if hasattr(res, "trace_start_ns") else None
    events = res.events()
    out = reduce(events, window_s, lo)
    out["spans"] = spans.reduce(events, window_s, lo)
    return out


def _is_launch(name: str) -> bool:
    return name.startswith(("cuda", "cu")) and not name.startswith("cudnn")


def _union(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class _HostOps:
    """Outermost host operator per thread, found by time."""

    def __init__(self, ops: Dict[int, List[Tuple[int, int, str]]]):
        self.tops: Dict[int, Tuple[List[int], List[Tuple[int, str]]]] = {}
        for tid, spans in ops.items():
            starts, rest = [], []
            end = -1
            for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
                if s >= end:
                    starts.append(s)
                    rest.append((e, name))
                    end = e
            self.tops[tid] = (starts, rest)

    def at(self, tid: int, t: int) -> Optional[str]:
        starts, rest = self.tops.get(tid, ([], []))
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and rest[i][0] >= t:
            return rest[i][1]
        return None


def reduce(events, window_s: float, lo: Optional[int] = None) -> dict:
    """Reduce profiler events; device intervals are clipped to the traced
    window [lo, lo + window_s] where the trace gives its start `lo`."""
    dev_type = torch.autograd.DeviceType.CUDA
    device: List[Tuple[int, int, str, int]] = []
    launches: Dict[int, Tuple[int, int, str]] = {}
    ops: Dict[int, List[Tuple[int, int, str]]] = defaultdict(list)
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
            device.append((s, end, name, e.correlation_id()))
        elif _is_launch(name):
            launches[e.correlation_id()] = (e.start_thread_id(), s, name)
        else:
            ops[e.start_thread_id()].append((s, end, name))
    host = _HostOps(ops)

    def client(corr: int) -> bool:
        if corr not in launches:
            return False
        tid, t, _ = launches[corr]
        return host.at(tid, t) == CLIENT
    theirs = [d for d in device if client(d[3])]
    device = [d for d in device if not client(d[3])]
    client_s = sum(e - s for s, e in _union(
        [(s, e) for s, e, _, _ in theirs])) / 1e9
    by_op: Dict[str, float] = defaultdict(float)
    for s, e, name, _ in device:
        by_op[name] += (e - s) / 1e9
    spans = _union([(s, e) for s, e, _, _ in device])
    busy_s = sum(e - s for s, e in spans) / 1e9
    first_of = {}
    for s, _, _, corr in device:
        first_of.setdefault(s, corr)
    gaps: Dict[str, float] = defaultdict(float)
    for (_, prev_end), (nxt, _) in zip(spans, spans[1:]):
        corr = first_of.get(nxt)
        label = "unattributed"
        if corr in launches:
            tid, t, call = launches[corr]
            label = host.at(tid, t) or call
        gaps[label] += (nxt - prev_end) / 1e9
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_s, "window_s": window_s,
            "device_kernels": len(device), "client_s": client_s,
            "breakdown": {"device_ops": [[n[:200], v] for n, v in top],
                          "idle_gaps": [[n[:200], v] for n, v in idle]}}
