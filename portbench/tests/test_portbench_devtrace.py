"""The traced run's reduction, on events made by hand: device work that a
client range launched is left out of the busy time, and the device's side
of a profiler range is no device work."""
import os
import sys
import time

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from portbench.lib import devtrace  # noqa: E402

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


class Ev:
    def __init__(self, name, start, dur, device=CPU, corr=0, tid=1,
                 annotation=False):
        self._v = (name, start, dur, device, corr, tid, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def _events():
    return [
        # the program's thread 1: an op that launches a 100 us kernel
        Ev("aten::mm", 0, 10_000, tid=1),
        Ev("cudaLaunchKernel", 1_000, 1_000, corr=1, tid=1),
        Ev("gemm", 20_000, 100_000, device=CUDA, corr=1),
        # a client's thread 2: a client range launches a 30 us kernel
        Ev(devtrace.CLIENT, 130_000, 20_000, tid=2, annotation=True),
        Ev("aten::index", 131_000, 5_000, tid=2),
        Ev("cudaLaunchKernel", 132_000, 1_000, corr=2, tid=2),
        Ev("index_kernel", 140_000, 30_000, device=CUDA, corr=2),
        Ev(devtrace.CLIENT, 140_000, 30_000, device=CUDA, corr=2,
           annotation=True),
        # the program again: 50 us
        Ev("aten::topk", 200_000, 10_000, tid=1),
        Ev("cudaLaunchKernel", 201_000, 1_000, corr=3, tid=1),
        Ev("topk_kernel", 250_000, 50_000, device=CUDA, corr=3),
    ]


def test_client_work_is_not_busy_time():
    r = devtrace.reduce(_events(), 300e-6, lo=0)
    assert r["busy_s"] == pytest.approx(150e-6)
    assert r["client_s"] == pytest.approx(30e-6)
    names = {n for n, _ in r["breakdown"]["device_ops"]}
    assert names == {"gemm", "topk_kernel"}
    gaps = dict(r["breakdown"]["idle_gaps"])
    assert gaps == {"aten::topk": pytest.approx(130e-6)}


def test_without_client_ranges_every_kernel_counts():
    ev = [e for e in _events() if e.name() != devtrace.CLIENT]
    r = devtrace.reduce(ev, 300e-6, lo=0)
    assert r["busy_s"] == pytest.approx(180e-6)
    assert r["client_s"] == 0.0


def _mixed():
    """Two program threads, an `ame.` span, a client, a kernel that runs
    past the window's end and a bare launch outside any operator."""
    return _events() + [
        Ev("ame.index.probed", 300_000, 40_000, tid=3, annotation=True),
        Ev("aten::index", 302_000, 8_000, tid=3),
        Ev("cudaLaunchKernel", 303_000, 1_000, corr=4, tid=3),
        Ev("gather_kernel", 320_000, 20_000, device=CUDA, corr=4),
        Ev("cudaLaunchKernel", 345_000, 1_000, corr=5, tid=4),
        Ev("scan_kernel", 360_000, 90_000, device=CUDA, corr=5),
    ]


# devtrace.reduce's readings of `_mixed()` over a 400 us window, as the
# benchmark's first traced runs took them: the spans table beside them
# changes none of these
MIXED = {"busy_s": 210e-6, "window_s": 400e-6, "device_kernels": 4,
         "client_s": 30e-6,
         "breakdown": {"device_ops": [["gemm", 100e-6],
                                      ["topk_kernel", 50e-6],
                                      ["scan_kernel", 40e-6],
                                      ["gather_kernel", 20e-6]],
                       "idle_gaps": [["aten::topk", 130e-6],
                                     ["ame.index.probed", 20e-6],
                                     ["cudaLaunchKernel", 20e-6]]}}


def test_the_reduction_reads_as_it_always_has():
    r = devtrace.reduce(_mixed(), 400e-6, lo=0)
    assert set(r) == set(MIXED)
    for key in ("busy_s", "window_s", "device_kernels", "client_s"):
        assert r[key] == pytest.approx(MIXED[key]), key
    for key, want in MIXED["breakdown"].items():
        got = r["breakdown"][key]
        assert [n for n, _ in got] == [n for n, _ in want], key
        assert [v for _, v in got] == pytest.approx([v for _, v in want])


class _Results:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events

    def trace_start_ns(self):
        return 0


class _Profiler:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": _Results(events)})()
        self.stopped = False

    def stop(self):
        self.stopped = True


def test_stop_adds_the_spans_table_of_the_same_events():
    from portbench.lib import spans
    prof = _Profiler(_mixed())
    r = devtrace.stop((prof, time.perf_counter() - 400e-6))
    assert prof.stopped
    window_s = r["window_s"]
    assert window_s >= 400e-6
    table = r.pop("spans")
    assert r == devtrace.reduce(_mixed(), window_s, lo=0)
    assert table == spans.reduce(_mixed(), window_s, lo=0)
    assert table["spans"]["ame.index.probed"]["n"] == 1
