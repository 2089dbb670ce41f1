"""The program window's parse (``harness/program_window.py``) on hand-written
Chrome-trace events: self time with nested children, launch calls given to
the innermost span of their thread, idle time under a ``tg.*`` span against
idle time under a harness span; then the seven readers of it, which read
nothing without a card or from a program without spans, and the parse of a
real CPU trace of a speech cell's loop."""

import json
from types import SimpleNamespace

import pytest
import torch

from harness import loops, manifest, program_window as pw

READERS = ["loader_wait_ms", "upload_ms", "plan_host_ms", "ops_host_ms", "ops_launches",
           "launch_host_ms", "idle_in_program_pct"]


def span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def launch(ts, corr, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "pid": 1, "tid": tid, "args": {"correlation": corr}}


def kernel(ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": ts, "dur": dur, "pid": 0,
            "tid": 7, "args": {"correlation": corr}}


def one_step():
    """One closed-loop step: pool_pick [0, 8], entry [10, 70] holding the plan
    [12, 40] (its kernel launch [20, 30] inside) and the delta [45, 65], sync
    [70, 100]. The device runs [30, 45] and [60, 80]; a second thread
    launches once with no span open."""
    return [
        span("pool_pick", 0, 8), span("entry", 10, 60), span("sync", 70, 30),
        span("tg.plan.MfccPlan", 12, 28), span("tg.kernel.fused_features", 20, 10),
        span("tg.op.mfcc.delta", 45, 20),
        launch(25, 1), launch(50, 2), launch(55, 3), launch(52, 4, tid=2),
        kernel(30, 15, 1), kernel(60, 10, 2), kernel(70, 10, 3), kernel(72, 1, 4),
    ]


def test_segments_give_each_instant_its_innermost_span():
    spans = [("entry", 10, 60), ("tg.plan.A", 12, 28), ("tg.kernel.k", 20, 10),
             ("tg.op.x", 45, 25.5)]  # outlasts entry by a rounding: cut at its end
    assert pw.segments(spans, 0, 100) == [
        (0, 10, None), (10, 12, "entry"), (12, 20, "tg.plan.A"), (20, 30, "tg.kernel.k"),
        (30, 40, "tg.plan.A"), (40, 45, "entry"), (45, 70, "tg.op.x"), (70, 100, None)]


def test_self_time_leaves_out_nested_children():
    w = pw.parse(one_step(), steps=1, attempts=1, counted_launches=1)
    assert w.base.window == (0.0, 100.0)
    assert w.self_us("tg.plan.") == 28 - 10
    assert w.self_us("tg.kernel.") == 10
    assert w.self_us("tg.op.") == 20
    assert w.self_us("tg.") == 48
    # two children under one parent, one of them nested again
    events = [span("entry", 0, 100), span("tg.plan.FeatureSet", 0, 100),
              span("tg.member.A", 10, 30), span("tg.op.a", 15, 10),
              span("tg.member.B", 50, 40), span("sync", 100, 1)]
    w = pw.parse(events, steps=2, attempts=1, counted_launches=0)
    assert w.self_us("tg.plan.") == 100 - 30 - 40
    assert w.self_us("tg.member.") == 20 + 40
    assert w.self_us("tg.plan.", "tg.member.") == 90
    assert w.self_us("tg.op.") == 10


def test_launch_calls_go_to_the_innermost_span_of_their_thread():
    w = pw.parse(one_step(), steps=1, attempts=1, counted_launches=1)
    # sorted by thread, then time: the second thread's launch has no span
    assert w.owners() == ["tg.kernel.fused_features", "tg.op.mfcc.delta", "tg.op.mfcc.delta",
                          None]
    assert w.launches_in("tg.op.") == 2
    assert w.launches_in("tg.kernel.") == 1
    assert w.launches_in("tg.plan.") == 0


def test_idle_under_a_program_span_against_a_harness_span():
    w = pw.parse(one_step(), steps=1, attempts=1, counted_launches=1)
    # idle [0, 30], [45, 60], [80, 100]: the program's spans hold [12, 30]
    # and [45, 60]; pool_pick, entry's own time, the gap between spans and
    # sync hold the rest
    assert w.base.gaps() == [(0.0, 30.0), (45.0, 60.0), (80.0, 100.0)]
    assert w.idle_in_program_share() == pytest.approx((18 + 15) / 65)


def test_spans_outside_the_window_and_other_events_are_left_out():
    events = one_step() + [span("tg.op.late", 150, 5), span("aten::mul", 46, 2),
                           {"ph": "X", "cat": "gpu_user_annotation", "name": "tg.op.mfcc.delta",
                            "ts": 60, "dur": 10, "pid": 0, "tid": 7}]
    w = pw.parse(events, steps=1, attempts=1, counted_launches=1)
    assert sorted(n for n, _, _, _ in w.spans) == [
        "tg.kernel.fused_features", "tg.op.mfcc.delta", "tg.plan.MfccPlan"]
    assert w.self_us("tg.op.") == 20


def ctx_with(window, device="cuda"):
    ctx = SimpleNamespace(trace=object(), device=torch.device(device), extra={})
    ctx.extra[pw.KEY] = window
    return ctx


def read_all(ctx):
    out = {}
    for name in READERS:
        reader = manifest.load_reader(name)
        reader.measure(ctx)
        out[name] = reader.read(ctx)
    return out


def test_readers_read_nothing_without_a_card():
    ctx = SimpleNamespace(trace=None, device=torch.device("cpu"), extra={})
    assert read_all(ctx) == {name: None for name in READERS}
    assert ctx.extra[pw.KEY] is None


def test_readers_read_nothing_from_a_program_without_spans():
    events = [e for e in one_step() if not e["name"].startswith("tg.")]
    w = pw.parse(events, steps=1, attempts=1, counted_launches=1)
    assert read_all(ctx_with(w)) == {name: None for name in READERS}


def test_readers_of_one_step():
    w = pw.parse(one_step(), steps=1, attempts=1, counted_launches=1)
    got = read_all(ctx_with(w))
    assert got == pytest.approx({"loader_wait_ms": None, "upload_ms": None,
                                 "plan_host_ms": 0.018, "ops_host_ms": 0.02, "ops_launches": 2.0,
                                 "launch_host_ms": 0.01, "idle_in_program_pct": 100 * 33 / 65})


def test_launch_host_reads_nothing_where_spans_and_counter_differ():
    w = pw.parse(one_step(), steps=1, attempts=1, counted_launches=2)
    assert manifest.load_reader("launch_host_ms").read(ctx_with(w)) is None


def test_pipeline_spans_per_batch():
    events = [span("pipeline_next", 0, 50), span("tg.pipeline.loader_wait", 1, 20),
              span("tg.pipeline.upload", 22, 8), span("tg.pipeline.step", 31, 10),
              span("pipeline_next", 50, 50), span("tg.pipeline.loader_wait", 51, 30),
              span("tg.pipeline.upload", 82, 12), span("sync", 100, 1)]
    w = pw.parse(events, steps=2, attempts=1, counted_launches=0)
    got = read_all(ctx_with(w))
    assert got["loader_wait_ms"] == pytest.approx(0.025)
    assert got["upload_ms"] == pytest.approx(0.010)
    rec = w.reconciliation()
    assert rec["pipeline_next_ms"] == pytest.approx(0.05)
    assert rec["program_ms"] == pytest.approx((20 + 8 + 10 + 30 + 12) / 2 * 1e-3)


def test_a_real_cpu_trace_of_the_speech_loop(tmp_path):
    """The events ``torch.profiler`` writes for the harness's spans and the
    port's, parsed as the program window parses them (no card: no launch)."""
    cell = manifest.load_cell(manifest.BENCH_DIR.parent, "speech_mfcc40.batch")
    dev = torch.device("cpu")
    system = cell.system_module.build(cell.config, cell.traffic, dev)
    pool = [torch.randn(2, 16000) for _ in range(2)]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        steps = loops.closed_loop(system, pool, dev, inflight=1, audio_per_step=2.0,
                                  steps=3, traced=True).steps
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    w = pw.parse(json.loads(path.read_text())["traceEvents"], steps, 1, 0)
    names = [n for n, _, _, _ in w.spans]
    assert names.count("tg.plan.MfccPlan") == 3 and names.count("tg.op.mfcc.delta") == 3
    assert w.self_us("tg.plan.") > 0 and w.self_us("tg.op.") > 0
    rec = w.reconciliation()
    assert 0 < rec["program_ms"] <= rec["entry_ms"]
