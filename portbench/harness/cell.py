"""One run of one cell: set-up, the measured window, the traced window, the
per-layer readers and the check against the plain reference.

``run_cell`` returns the result line's object and the check's lines; the
command line in ``run.py`` prints them. Tests call it with ``device="cpu"``
to drive everything but the look for a card.
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from . import inputs, judge, loops, manifest, tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "spectrograms_tpu")
PEAK_F32_FLOPS = 67e12    # H100 SXM, float32 outside the tensor cores (data sheet)
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3 (data sheet)


class NoDevice(RuntimeError):
    """The cell asks for more CUDA devices than the machine shows."""


def process_age_s() -> float:
    """Seconds since this process started (``/proc``), the set-up clock."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared as whole names (``spectrograms_tpu_torch`` is not one)."""
    return sorted({k.split(".")[0] for k in list(sys.modules)} & set(FORBIDDEN))


def power_limit_w():
    """The card's power limit from ``nvidia-smi``, or None."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _check_device(cell, device):
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < cell.chips:
        raise NoDevice(f"the cell asks for {cell.chips} CUDA devices, "
                       f"{torch.cuda.device_count()} visible")
    return torch.device("cuda", 0)


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool,
             device=None, phases=None, bench_dir=manifest.BENCH_DIR,
             patch_system=None) -> tuple:
    """(result object, check lines). ``device`` None: CUDA, or NoDevice.
    ``patch_system(system)`` lets a test break the timed path underneath."""
    phases = dict(phases or {})
    t_mark = process_age_s()

    def phase(name):
        nonlocal t_mark
        now = process_age_s()
        phases[name] = phases.get(name, 0.0) + (now - t_mark)
        t_mark = now

    cell = manifest.load_cell(Path(root), workload, bench_dir)
    cfg, tr = cell.config, cell.traffic
    dev = _check_device(cell, device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()
        torch.empty(1, device=dev)
        torch.cuda.synchronize(dev)
    phase("cuda_context")

    system = cell.system_module.build(cfg, tr, dev)
    if patch_system is not None:
        system = patch_system(system)
    phase("plan_build")

    corpus_dir, paths, pcm, pool = None, None, None, None
    try:
        kind = tr["kind"]
        if kind == "closed":
            pool = inputs.make_pool(tr, seed, dev)
        elif kind == "wav":
            corpus_dir = Path(tempfile.mkdtemp(prefix="portbench_corpus_"))
            paths, pcm = inputs.write_corpus(tr, seed, corpus_dir)
        else:
            raise ValueError(f"portbench: unknown traffic kind {kind!r}")
        if cuda:
            torch.cuda.synchronize(dev)
        phase("inputs")

        pipe = None
        if kind == "closed":
            inflight = int(tr.get("inflight", 1))
            audio_per_step = float(tr["clips"]) * float(tr["clip_s"])

            def loop(**kw):
                return loops.closed_loop(system, pool, dev, inflight=inflight,
                                         audio_per_step=audio_per_step, **kw)

            def traced_loop():
                return loop(steps=int(tr["trace_steps"]), traced=True).steps

            loop(steps=1)
            phase("first_call")
            loop(steps=max(2 * inflight, len(pool)) + 2)
        else:
            pipe = system.pipeline(tr)

            def loop(**kw):
                return loops.wav_loop(system, pipe, paths, dev, seed=seed,
                                      sample_rate=float(tr["sr"]), **kw)

            def traced_loop():
                return loop(passes=int(tr["trace_passes"]), traced=True).steps

            loop(passes=1)
            phase("first_call")
            loop(passes=1)
        phase("warm_up")
        setup_s = process_age_s()

        sampler = loops.Sampler(int(tr.get("check_samples", 4)), seed)
        win = loop(seconds=seconds, sampler=sampler)
        if cuda:
            torch.cuda.synchronize(dev)
            memory_peak = int(torch.cuda.max_memory_allocated(dev))
        else:
            memory_peak = 0

        device_info, breakdown, tr_obj = {}, None, None
        if trace and cuda:
            tr_obj = tracing.trace_window(traced_loop)
        ctx = SimpleNamespace(cell=cell, config=cfg, traffic=tr, system=system,
                              reference=cell.reference_module, window=win, trace=tr_obj,
                              setup_s=setup_s, paths=paths, device=dev, extra={},
                              peak_flops=PEAK_F32_FLOPS, peak_bytes=PEAK_HBM_BYTES)
        metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, ctx, bench_dir)
        if trace:
            if tr_obj is not None:
                device_info = {"busy_s": tr_obj.busy_us() * 1e-6,
                               "window_s": tr_obj.window_us * 1e-6,
                               "traced_steps": tr_obj.steps,
                               "trace_attempts": tr_obj.attempts}
                breakdown = tr_obj.breakdown()

        # the check: the program's state is freed, the reference runs in blocks
        samples = sampler.items
        if kind == "closed":
            needed = sorted({i for i, _ in samples})
            kept_inputs = {i: pool[i] for i in needed}
            pool = None
        del system, pipe, loop, traced_loop, ctx
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        readings = []
        for s in samples:
            if kind == "closed":
                i, out = s
                x = kept_inputs[i]
                extra = {}
            else:
                idx, out, lengths, mask = s
                x = torch.from_numpy(pcm[np.asarray(idx)]).to(dev)
                extra = {"lengths": lengths, "frame_mask": mask, "pcm": True}
            readings.append(cell.reference_module.check(cfg, tr, x, out, **extra))
        numbers = judge.worst(readings)
        correct, checks, _ = judge.verdict(numbers, cfg["limits"])
        check_s = time.perf_counter() - t_check
    finally:
        if corpus_dir is not None:
            shutil.rmtree(corpus_dir, ignore_errors=True)

    device_out = {"platform": "gpu" if cuda else dev.type,
                  "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                  "count": cell.chips,
                  "memory_peak_bytes": memory_peak}
    device_out.update(device_info)
    if cuda:
        device_out["power_limit_w"] = power_limit_w()
    result = {"correct": bool(correct and samples),
              "attempted": win.steps,
              "failed": sum(1 for r in readings if not judge.verdict(r, cfg["limits"])[0]),
              "metrics": metrics,
              "device": device_out}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["setup"] = {"setup_s": setup_s, "phases_s": phases, "check_s": check_s,
                       "window_steps": win.steps, "window_wall_s": win.wall_s,
                       "steps_per_second": win.rates_per_second(),
                       "enqueue_ms_mean": 1e3 * float(np.mean(win.enqueue_s)) if win.enqueue_s
                       else None,
                       "samples_checked": len(samples)}
    result["checks"] = checks
    lines = [f"check {k} {v['value']!r} limit {v['limit']!r}" for k, v in checks.items()]
    return result, lines


def read_metrics(entries: list, ctx, bench_dir) -> dict:
    """{name: {"value", "unit"}} of the metrics in ``entries``: each read by
    its own file ``metrics/<name>.py`` (``measure(ctx)`` first, where the
    reader has one); a reader that finds nothing returns None and its metric
    is left out."""
    readers = [(m, manifest.load_reader(m["name"], bench_dir)) for m in entries]
    for _, r in readers:
        if hasattr(r, "measure"):
            r.measure(ctx)
    metrics = {}
    for m, r in readers:
        value = r.read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return metrics
