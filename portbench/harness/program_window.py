"""The program's window: one more traced window of the cell, read for the
port's own spans (``tg.*``, ``spectrograms_tpu_torch.spans``) beside the
harness's, all on Kineto's one clock.

Only in ``--trace 1`` runs on a card, once the harness's traced window has
closed, ``window(ctx)`` traces the cell again: a closed cell runs
``trace_steps`` steps of ``loops.closed_loop`` over a pool drawn from seed 0
(the values do not change the work, and nothing here is checked), a WAV
cell ``trace_passes`` passes of ``loops.wav_loop`` through a new pipeline
of the system, after one untraced step or pass of each. A window that lost
kernel records is traced again, as ``tracing.trace_window`` does. The
result is kept in ``ctx.extra``; the pool and the pipeline are freed on
return. Without a card, or outside a traced run, it is None and so is
every reader of it.

The parse keeps the device operations, the harness's spans and the
window they bound (``tracing._parse``), the ``tg.*`` spans, the CUDA
kernel launch calls, and the delta of the kernels' ``.launches`` counters
over the traced loop. A span's self time is its length less the part its
child spans on the same thread cover; a launch call belongs to the
innermost span open on its thread when it starts. A program without the
spans (an older tree) gives a window with none, and every reader of it
returns None.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from bisect import bisect_right
from collections import Counter
from dataclasses import dataclass
from pathlib import Path

import torch

from . import inputs, loops, tracing

PREFIX = "tg."
SPAN_CATS = ("user_annotation", "cpu_op", "python_function")
KEY = "program_window"


def segments(spans: list, lo: float, hi: float) -> list:
    """(start, end, name) pieces of [lo, hi] on one thread, each labelled with
    the innermost of ``spans`` ((name, start, duration), nested as one
    thread's spans are) open over it, or None where none is. A child that
    outlasts its parent by a rounding is cut at the parent's end."""
    out, stack, cur = [], [], lo

    def advance(t):
        nonlocal cur
        while stack and stack[-1][0] <= t:
            end, name = stack.pop()
            if end > cur:
                out.append((cur, end, name))
                cur = end
        if t > cur:
            out.append((cur, t, stack[-1][1] if stack else None))
            cur = t

    for name, s, d in sorted(spans, key=lambda x: (x[1], -x[2])):
        advance(s)
        end = s + d if not stack else min(s + d, stack[-1][0])
        stack.append((end, name))
    advance(hi)
    return [(max(s, lo), min(e, hi), n) for s, e, n in out if min(e, hi) > max(s, lo)]


@dataclass
class ProgramWindow:
    """A traced window of the program: the harness's ``tracing.Trace`` and,
    per host thread, the innermost-span segments and the launch calls."""

    base: tracing.Trace
    spans: list                  # (name, start, duration, tid) of each tg.* span in the window
    segments: dict               # tid -> [(start, end, innermost span name or None)]
    launch_calls: list           # (tid, start) of each kernel launch call in the window
    harness_tid: object          # the thread that ran the harness's spans
    counted_launches: int        # delta of the kernels' .launches over the traced loop
    spent_s: float = 0.0         # host seconds the extra window took, tracing and parse

    @property
    def steps(self) -> int:
        return self.base.steps

    @property
    def has_program_spans(self) -> bool:
        return bool(self.spans)

    def span_total_us(self, name: str) -> float:
        """Summed length of the tg.* spans called ``name``."""
        return sum(d for n, _, d, _ in self.spans if n == name)

    def span_count(self, prefix: str) -> int:
        return sum(1 for n, _, _, _ in self.spans if n.startswith(prefix))

    def self_us(self, *prefixes) -> float:
        """Self time of the spans whose names start with one of ``prefixes``,
        summed over every thread."""
        return sum(e - s for segs in self.segments.values() for s, e, n in segs
                   if n is not None and n.startswith(prefixes))

    def owners(self) -> list:
        """The innermost span open on its thread at the start of each launch
        call (None where none is), in the order of ``launch_calls``."""
        starts = {tid: [s for s, _, _ in segs] for tid, segs in self.segments.items()}
        out = []
        for tid, t in self.launch_calls:
            segs = self.segments.get(tid, [])
            i = bisect_right(starts.get(tid, []), t) - 1
            out.append(segs[i][2] if i >= 0 and segs[i][0] <= t < segs[i][1] else None)
        return out

    def launches_in(self, *prefixes) -> int:
        """Kernel launch calls made inside spans named with one of ``prefixes``."""
        return sum(1 for n in self.owners() if n is not None and n.startswith(prefixes))

    def idle_in_program_share(self):
        """Share of the device's idle time in the window during which the
        innermost span open on the harness's thread is a tg.* span."""
        gaps = self.base.gaps()
        idle = sum(e - s for s, e in gaps)
        if idle <= 0:
            return None
        segs = self.segments.get(self.harness_tid, [])
        starts = [s for s, _, _ in segs]
        inside = 0.0
        for g0, g1 in gaps:
            i = max(0, bisect_right(starts, g0) - 1)
            while i < len(segs) and segs[i][0] < g1:
                s, e, n = segs[i]
                if n is not None and n.startswith(PREFIX):
                    inside += max(0.0, min(e, g1) - max(s, g0))
                i += 1
        return inside / idle

    def harness_us(self, name: str) -> float:
        return sum(d for n, _, d in self.base.spans if n == name)

    def reconciliation(self) -> dict:
        """Per step, in ms: the harness's ``entry`` and ``pipeline_next``
        spans against the self times of the program's layers inside them."""
        per = 1e-3 / max(1, self.steps)
        out = {"steps": self.steps, "window_s": self.base.window_us * 1e-6,
               "entry_ms": self.harness_us("entry") * per,
               "pipeline_next_ms": self.harness_us("pipeline_next") * per}
        for key, prefixes in (("loader_wait_ms", ("tg.pipeline.loader_wait",)),
                              ("upload_ms", ("tg.pipeline.upload",)),
                              ("pipeline_step_self_ms", ("tg.pipeline.step",)),
                              ("pipeline_batch_ms", ("tg.pipeline.batch",)),
                              ("plan_host_ms", ("tg.plan.", "tg.member.")),
                              ("ops_host_ms", ("tg.op.",)),
                              ("launch_host_ms", ("tg.kernel.",))):
            out[key] = self.self_us(*prefixes) * per
        out["program_ms"] = self.self_us(PREFIX) * per
        out["spans"] = len(self.spans) / max(1, self.steps)
        # launch calls a step, by the innermost span open at each
        launches = Counter((n or "none").split(".")[1] if (n or "").startswith(PREFIX)
                           else (n or "none") for n in self.owners())
        out["launches"] = {k: v / max(1, self.steps) for k, v in sorted(launches.items())}
        return out


def _launch_count() -> int:
    """The kernels' ``.launches`` counters, summed."""
    from spectrograms_tpu_torch.ops import fused_factored as ff

    return ff.fused_factored_features.launches + ff.fused_tier_features.launches


def _is_launch(e) -> bool:
    name = e.get("name", "")
    return (e.get("cat") in ("cuda_runtime", "cuda_driver")
            and ("LaunchKernel" in name or "LaunchCooperativeKernel" in name))


def parse(events: list, steps: int, attempts: int, counted_launches: int) -> ProgramWindow:
    """The program window of a Chrome trace's events (see the module's
    docstring)."""
    base = tracing._parse(events, steps, attempts)
    lo, hi = base.window
    harness_tids = Counter(e.get("tid") for e in events if e.get("ph") == "X"
                           and e.get("name") in tracing.HARNESS_SPANS
                           and e.get("cat") in SPAN_CATS)
    harness_tid = harness_tids.most_common(1)[0][0]
    by_tid: dict = {}
    tg = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in SPAN_CATS or "ts" not in e:
            continue
        name = e.get("name", "")
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        if s + d < lo or s > hi:
            continue
        if name.startswith(PREFIX):
            tg.append((name, s, d, e.get("tid")))
        elif name not in tracing.HARNESS_SPANS:
            continue
        by_tid.setdefault(e.get("tid"), []).append((name, s, d))
    segs = {tid: segments(sp, lo, hi) for tid, sp in by_tid.items()}
    launches = sorted((e.get("tid"), float(e["ts"])) for e in events
                      if _is_launch(e) and "ts" in e and lo <= float(e["ts"]) <= hi)
    return ProgramWindow(base=base, spans=tg, segments=segs, launch_calls=launches,
                         harness_tid=harness_tid, counted_launches=counted_launches)


def _trace(run_steps) -> ProgramWindow:
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    lost = []
    with tempfile.TemporaryDirectory(prefix="portbench_program_") as tmp:
        for attempt in range(1, tracing.ATTEMPTS + 1):
            before = _launch_count()
            with torch.profiler.profile(activities=acts) as prof:
                steps = run_steps()
            counted = _launch_count() - before
            path = Path(tmp) / f"window_{attempt}.json"
            prof.export_chrome_trace(str(path))
            with open(path) as f:
                events = json.load(f)["traceEvents"]
            path.unlink()
            launches, lost = tracing.lost_kernels(events)
            if launches and not lost:
                return parse(events, steps, attempt, counted)
    raise RuntimeError(f"portbench: {tracing.ATTEMPTS} program windows lost kernel records "
                       f"({len(lost)} launches without a kernel, e.g. {lost[:3]})")


def _run(ctx) -> ProgramWindow:
    t0 = time.perf_counter()
    tr, dev = ctx.traffic, ctx.device
    if tr["kind"] == "closed":
        pool = inputs.make_pool(tr, 0, dev)
        inflight = int(tr.get("inflight", 1))
        audio = float(tr["clips"]) * float(tr["clip_s"])

        def loop(steps, traced):
            return loops.closed_loop(ctx.system, pool, dev, inflight=inflight,
                                     audio_per_step=audio, steps=steps, traced=traced).steps

        loop(1, False)
        result = _trace(lambda: loop(int(tr["trace_steps"]), True))
    else:
        pipe = ctx.system.pipeline(tr)

        def loop(passes, traced):
            return loops.wav_loop(ctx.system, pipe, ctx.paths, dev, seed=0,
                                  sample_rate=float(tr["sr"]), passes=passes,
                                  traced=traced).steps

        loop(1, False)
        result = _trace(lambda: loop(int(tr["trace_passes"]), True))
    result.spent_s = time.perf_counter() - t0
    return result


def window(ctx):
    """The cell's program window (traced once a run), or None without a
    card or outside a traced run."""
    if KEY not in ctx.extra:
        result = None
        if ctx.trace is not None and ctx.device.type == "cuda":
            result = _run(ctx)
            if result.has_program_spans:
                line = dict(result.reconciliation(), spent_s=result.spent_s)
                print("portbench: program window " + json.dumps(line), file=sys.stderr)
        ctx.extra[KEY] = result
    return ctx.extra[KEY]


def per_step_ms(ctx, read) -> float:
    """``read(window)`` µs over the window's steps, in ms; None where the
    window is missing or holds no program span."""
    w = window(ctx)
    if w is None or not w.has_program_spans or w.steps == 0:
        return None
    value = read(w)
    return None if value is None else value / w.steps * 1e-3
