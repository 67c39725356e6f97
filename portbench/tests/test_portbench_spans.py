"""The traced window read by the program's spans: the spans table and the
``span|op`` gap labels on events made by hand, the metric readers of a
window's spans and counters, the window's counters in an untraced run, and
the span tool's run of a tiny cell on the CPU."""
import importlib.util
import os
import sys
import time
import types

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from portbench.lib import (  # noqa: E402
    devtrace, harness, manifest, spans, tiny)
from portbench.lib.readers import Counters  # noqa: E402

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


class Ev:
    """A profiler event; `tid` is its system thread (`device_resource_id`),
    `start_tid` the id PyTorch files it under (the profiling thread's for a
    launch that no aten operator encloses)."""

    def __init__(self, name, start, dur, device=CPU, corr=0, tid=1,
                 annotation=False, start_tid=None):
        self.name = lambda: name
        self.start_ns = lambda: start
        self.duration_ns = lambda: dur
        self.device_type = lambda: device
        self.correlation_id = lambda: corr
        self.device_resource_id = lambda: tid
        self.start_thread_id = lambda: tid if start_tid is None else start_tid
        self.is_user_annotation = lambda: annotation


def _events():
    return [
        # a worker: the full scan's flat copy (an aten op inside its span)
        Ev("ame.index.full_scan.flat_copy", 0, 20_000, annotation=True,
           tid=5),
        Ev("aten::cat", 1_000, 14_000, tid=5),
        Ev("cudaLaunchKernel", 2_000, 1_000, corr=1, tid=5),
        Ev("cat_kernel", 30_000, 100_000, device=CUDA, corr=1),
        # its scan: a hand-written kernel's bare launch inside two spans,
        # which PyTorch files under the profiling thread's id
        Ev("ame.index.full_scan.scan", 20_000, 40_000, annotation=True,
           tid=5),
        Ev("ame.kernel.scan_scores", 25_000, 2_000, annotation=True, tid=5),
        Ev("cudaLaunchKernel", 26_000, 500, corr=2, tid=5, start_tid=1),
        Ev("scan_kernel", 150_000, 50_000, device=CUDA, corr=2),
        # a client's work on its own thread, left out of the busy time
        Ev(devtrace.CLIENT, 100_000, 20_000, tid=2, annotation=True),
        Ev("cudaLaunchKernel", 101_000, 500, corr=4, tid=2),
        Ev("gather_kernel", 200_000, 10_000, device=CUDA, corr=4),
        # an operator outside every span
        Ev("aten::topk", 60_000, 10_000, tid=5),
        Ev("cudaLaunchKernel", 61_000, 1_000, corr=3, tid=5),
        Ev("topk_kernel", 230_000, 10_000, device=CUDA, corr=3),
    ]


def test_the_spans_table_and_the_span_op_gap_labels():
    r = spans.reduce(_events(), 300e-6, lo=0)
    t = r["spans"]
    assert t["ame.index.full_scan.flat_copy"] == pytest.approx(
        {"n": 1, "host_s": 20e-6, "device_s": 100e-6, "idle_s": 0.0})
    # the innermost span takes the launch: the kernel's, not the scan's
    assert t["ame.kernel.scan_scores"] == pytest.approx(
        {"n": 1, "host_s": 2e-6, "device_s": 50e-6, "idle_s": 20e-6})
    assert t["ame.index.full_scan.scan"] == pytest.approx(
        {"n": 1, "host_s": 40e-6, "device_s": 0.0, "idle_s": 0.0})
    assert r["unspanned"] == pytest.approx({"device_s": 10e-6,
                                            "idle_s": 30e-6})
    assert dict(r["idle_gaps"]) == pytest.approx({
        "aten::topk": 30e-6,
        "ame.kernel.scan_scores|cudaLaunchKernel": 20e-6})
    # the busy time and the client rule are devtrace's own
    d = devtrace.reduce(_events(), 300e-6, lo=0)
    assert r["busy_s"] == pytest.approx(d["busy_s"]) == pytest.approx(160e-6)
    assert sum(s["device_s"] for s in t.values()) + \
        r["unspanned"]["device_s"] == pytest.approx(r["busy_s"])
    # devtrace, left as it is, names a gap by the outermost range on the
    # thread PyTorch files the launch under: for the kernel's launch, none
    assert dict(d["breakdown"]["idle_gaps"]) == pytest.approx({
        "aten::topk": 30e-6, "cudaLaunchKernel": 20e-6})


def test_a_gap_label_keeps_to_64_characters():
    long = "ame." + "x" * 70
    ev = [Ev("k0", 0, 1_000, device=CUDA, corr=9),
          Ev(long, 1_000, 5_000, annotation=True),
          Ev("aten::" + "y" * 40, 1_500, 1_000),
          Ev("cudaLaunchKernel", 2_000, 100, corr=1),
          Ev("k1", 10_000, 1_000, device=CUDA, corr=1)]
    (label, gap), = spans.reduce(ev, 20e-6, lo=0)["idle_gaps"]
    assert len(label) == 64 and label.startswith(long[:64])
    assert gap == pytest.approx(9e-6)


def _tool():
    spec = importlib.util.spec_from_file_location(
        "portbench_trace_spans", os.path.join(ROOT, "portbench",
                                              "trace_spans.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the five readings of the program's spans and counters, by their readers
FIVE = ("probed_host_ms", "answer_copy_ms.query", "scan_launches_per_query",
        "admit_wait_ms.query", "insert_clone_ms")


def _ctx(table, delta):
    """A reader's context with a spans table and a window's counter
    differences (and scheduler aggregates that saw nothing)."""
    return types.SimpleNamespace(
        spans=table, counters=Counters(delta),
        delta=lambda kind: (0, 0.0, 0.0))


def test_each_reading_from_a_window_and_none_from_an_empty_one():
    tool = _tool()
    table = {"spans": {
        "ame.index.full_scan.flat_copy": {"n": 4, "host_s": 0.001,
                                          "device_s": 0.016, "idle_s": 0},
        "ame.index.probed": {"n": 2, "host_s": 0.006, "device_s": 0.001,
                             "idle_s": 0},
        "ame.coll.query.to_host": {"n": 8, "host_s": 0.004,
                                   "device_s": 0.0, "idle_s": 0.001},
        "ame.index.insert.clone": {"n": 2, "host_s": 0.0,
                                   "device_s": 0.008, "idle_s": 0}}}
    delta = {"coll.mem.queries": 30, "launches.scan_scores.stream": 9,
             "launches.scan_scores.generic": 1,
             "launches.scan_scores_q8.stream": 2,
             "launches.scan_scores.two_segment": 6,
             "launches.kmeans_assign.wgmma": 7,
             "sched.query.n": 8, "sched.query.admit_wait_s": 0.04,
             "coll.mem.insert_calls": 4, "coll.mem.insert_lock_wait_s": 0.02,
             "coll.mem.rebuilds": 2, "coll.mem.rebuild_lock_hold_s": 0.1}
    want = {"probed_host_ms": 3.0, "answer_copy_ms.query": 0.5,
            # 12 launches of the variants a 30 vectors; the two-segment
            # key counts 6 of them again and is left out
            "scan_launches_per_query": 12 / 30,
            "admit_wait_ms.query": 5.0, "insert_clone_ms": 4.0}
    ctx = _ctx(table, delta)
    got = tool.readings(ctx)
    assert set(FIVE) <= set(got)
    for name in FIVE:
        assert manifest.reader(name, ROOT)(ctx) == pytest.approx(
            want[name]), name
        assert got[name] == pytest.approx(want[name]), name
    empty = tool.readings(_ctx({"spans": {}}, {}))
    assert set(empty) == set(got)
    assert all(v is None for v in empty.values())
    untraced = _ctx(None, delta)
    for name in ("probed_host_ms", "answer_copy_ms.query",
                 "insert_clone_ms"):
        assert manifest.reader(name, ROOT)(untraced) is None


def test_scan_launches_count_every_variant_but_the_two_segment_key():
    # a variant the port may add later counts as the ones it has now; the
    # two-segment key, the other kernels and the segsum launch do not
    delta = {"coll.mem.queries": 10, "launches.scan_scores.stream": 2,
             "launches.scan_scores.a_later_variant": 3,
             "launches.scan_scores_q8.generic": 1,
             "launches.scan_scores.two_segment": 4,
             "launches.kmeans_assign.wgmma": 9, "launches.segsum_gemm": 5}
    read = manifest.reader("scan_launches_per_query", ROOT)
    assert read(_ctx({"spans": {}}, delta)) == pytest.approx(6 / 10)
    assert read(_ctx({"spans": {}}, {"launches.scan_scores.stream": 2})) \
        is None


def test_the_readings_are_the_per_layer_metrics_of_spans_and_counters():
    from portbench.lib.manifest import benchmark
    program = {m["name"] for m in benchmark(ROOT)["per_layer"]
               if m["source"] in ("program_span", "program_counter")}
    assert set(FIVE) <= program
    assert set(_tool().readings(_ctx({"spans": {}}, {}))) == program


def test_the_window_counters_of_an_untraced_run():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        r, ctx = harness.run(tiny.cell("f32-hybrid", ROOT), 2 ** 33 + 78,
                             1.5, False, t_process=time.perf_counter(),
                             device="cpu", want_ctx=True)
    finally:
        torch.set_num_threads(n)
    assert r["correct"], r["checks"]
    assert ctx.spans is None and ctx.trace is None
    # query tasks the scheduler completed between the window's two reads:
    # every request answered inside the window, and at most every request
    # the window sent (none of the warm-up's, which had all come back)
    n_done = ctx.counters("sched.query.n")
    answered = sum(q.ok and q.t_done <= ctx.t1 for q in ctx.requests)
    assert 0 < answered <= n_done <= len(ctx.requests)
    assert ctx.counters("coll.mem.insert_calls") > 0
    assert ctx.counters("no.such.counter") == 0
    # the scheduler's share per op kind and the window's rebuilds come from
    # the same two snapshots
    assert ctx.delta("query") == tuple(
        ctx.counters(f"sched.query.{k}") for k in ("n", "wait_s", "lat_s"))
    assert ctx.delta("query")[1] > 0 and ctx.delta("no_such_kind") == (0,) * 3
    assert r["notes"]["rebuilds_in_window"] == ctx.counters("sched.rebuild.n")
    assert "ctx" not in r


def test_the_tool_reads_a_tiny_cell_on_the_cpu():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = _tool().traced(tiny.cell("f32-hybrid", ROOT), 2 ** 33 + 77,
                             1.5, device="cpu")
    finally:
        torch.set_num_threads(n)
    assert out["result"]["correct"], out["result"]["checks"]
    assert "ctx" not in out["result"]
    t = out["spans"]["spans"]
    for name in ("ame.coll.query.to_host", "ame.index.probed",
                 "ame.index.full_scan.flat_copy", "ame.coll.writer_lock",
                 "ame.index.insert.clone", "ame.index.delete.mask"):
        assert t[name]["n"] > 0 and t[name]["host_s"] > 0, name
    c = out["counters"]
    assert c["coll.mem.insert_calls"] > 0 and c["sched.query.n"] > 0
    assert c["coll.mem.inserts"] > 0 and c["sched.insert.n"] > 0
    got = out["readings"]
    assert got["probed_host_ms"] > 0 and got["answer_copy_ms.query"] > 0
    assert got["admit_wait_ms.query"] >= 0
    # the run's per-layer metrics are the same readers over the same run
    for name, m in out["result"]["metrics"].items():
        if name in got:
            assert m["value"] == got[name], name
