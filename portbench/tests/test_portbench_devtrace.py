"""The traced run's reduction, on events made by hand: device work that a
client range launched is left out of the busy time, and the device's side
of a profiler range is no device work."""
import os
import sys

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
