"""The traced window: ``torch.profiler`` in the run's own process, read back
from its Chrome trace.

``lost_kernels`` is a frozen copy of ``spectrograms_tpu_torch.profiling.
lost_kernels``: Kineto has been seen to drop a window's kernel records (75 s
after a process's last trace, and once in twelve on a fresh process's first
trace), so a window whose launches lack their kernels is traced again, at
most ``ATTEMPTS`` times in all, and the run fails after that.
"""

from __future__ import annotations

import json
import tempfile
from dataclasses import dataclass
from pathlib import Path

import torch

ATTEMPTS = 3
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HARNESS_SPANS = ("entry", "sync", "pool_pick", "pipeline_next")


def lost_kernels(events) -> tuple:
    """(launches, lost) of a Chrome trace's events: the names of its kernel
    launches (CUDA runtime or driver API), and of those whose correlation id no
    kernel record carries. A launch made while a stream captures a CUDA graph
    runs no kernel and is left out."""
    api = sorted((e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")),
                 key=lambda e: e.get("ts", 0.0))
    capturing: dict = {}
    launches = []
    for e in api:
        name, tid = e.get("name", ""), e.get("tid")
        if "StreamBeginCapture" in name:
            capturing[tid] = capturing.get(tid, 0) + 1
        elif "StreamEndCapture" in name:
            capturing[tid] = max(0, capturing.get(tid, 0) - 1)
        elif ("LaunchKernel" in name or "LaunchCooperativeKernel" in name) \
                and not capturing.get(tid):
            launches.append(e)
    ran = {e.get("args", {}).get("correlation") for e in events if e.get("cat") == "kernel"}
    return ([e["name"] for e in launches],
            [e["name"] for e in launches if e.get("args", {}).get("correlation") not in ran])


@dataclass
class Trace:
    """A traced window: device operations and harness spans, in µs of one clock."""

    ops: list          # (category, name, start, duration) of each device operation
    spans: list        # (name, start, duration) of each harness span
    window: tuple      # (start, end) of the traced loop
    steps: int         # loop steps in the window
    attempts: int      # windows traced until one kept its kernels

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self, match=None) -> list:
        return [o for o in self.ops if o[0] == "kernel" and (match is None or match(o[1]))]

    def busy_us(self) -> float:
        """Length of the union of device-operation intervals inside the window."""
        lo, hi = self.window
        iv = sorted((max(lo, s), min(hi, s + d)) for _, _, s, d in self.ops)
        total, cur_s, cur_e = 0.0, None, None
        for s, e in iv:
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total

    def gaps(self) -> list:
        """(start, end) of each idle stretch of the device inside the window."""
        lo, hi = self.window
        iv = sorted((s, s + d) for _, _, s, d in self.ops)
        out, cur = [], lo
        for s, e in iv:
            if s > cur:
                out.append((cur, min(s, hi)))
            cur = max(cur, e)
            if cur >= hi:
                break
        if cur < hi:
            out.append((cur, hi))
        return [(s, e) for s, e in out if e > s]

    def span_at(self, t: float) -> str:
        """The innermost harness span open on the host at time ``t``."""
        best, best_d = "outside_spans", None
        for name, s, d in self.spans:
            if s <= t <= s + d and (best_d is None or d < best_d):
                best, best_d = name, d
        return best

    def breakdown(self) -> dict:
        """The ten device operations that took most time (summed by name), and
        the idle time summed by the harness span the host was in."""
        by_op: dict = {}
        for _, name, _, d in self.ops:
            by_op[name] = by_op.get(name, 0.0) + d * 1e-6
        idle: dict = {}
        for s, e in self.gaps():
            label = self.span_at(0.5 * (s + e))
            idle[label] = idle.get(label, 0.0) + (e - s) * 1e-6
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}


def _parse(events: list, steps: int, attempts: int) -> Trace:
    ops = [(e["cat"], e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)))
           for e in events if e.get("cat") in DEVICE_CATS and "ts" in e]
    spans = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
             for e in events if e.get("ph") == "X" and e.get("name") in HARNESS_SPANS
             and e.get("cat") in ("user_annotation", "cpu_op", "python_function")]
    if not spans:
        raise RuntimeError("portbench: the trace holds none of the harness's spans")
    lo = min(s for _, s, _ in spans)
    hi = max(s + d for _, s, d in spans)
    return Trace(ops=ops, spans=spans, window=(lo, hi), steps=steps, attempts=attempts)


def trace_window(run_steps) -> Trace:
    """Trace ``run_steps()`` (which returns the steps it ran) under
    ``torch.profiler``; a window that lost kernel records is traced again."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    lost = []
    with tempfile.TemporaryDirectory(prefix="portbench_trace_") as tmp:
        for attempt in range(1, ATTEMPTS + 1):
            with torch.profiler.profile(activities=acts) as prof:
                steps = run_steps()
            path = Path(tmp) / f"window_{attempt}.json"
            prof.export_chrome_trace(str(path))
            with open(path) as f:
                events = json.load(f)["traceEvents"]
            path.unlink()
            launches, lost = lost_kernels(events)
            if launches and not lost:
                return _parse(events, steps, attempt)
    raise RuntimeError(f"portbench: {ATTEMPTS} traced windows lost kernel records "
                       f"({len(lost)} launches without a kernel, e.g. {lost[:3]})")
