"""gl_roofline_pct: the least time of one Griffin-Lim iteration on the H100
over ``gl_iter_device_ms``, the device time one iteration took.

The least time is the larger of the iteration's operations over 67 TFLOP/s
(f32 outside the tensor cores) and its bytes over 3.35 TB/s (H100 SXM, data
sheet). The counts are the frozen task count of the configuration's
reference module (``gl_task``): an FFT-based iteration, whatever route the
program takes. None wherever ``gl_iter_device_ms`` is."""

from pathlib import Path

from harness.manifest import load_module

_iteration = load_module(Path(__file__).with_name("gl_iter_device_ms.py"), "metric")


def measure(ctx):
    _iteration.measure(ctx)


def read(ctx):
    per_iteration_ms = _iteration.read(ctx)
    task = getattr(ctx.reference, "gl_task", None)
    if per_iteration_ms is None or task is None:
        return None
    flops, nbytes = task(ctx.config, ctx.traffic)
    least_s = max(flops / ctx.peak_flops, nbytes / ctx.peak_bytes)
    return 100.0 * least_s / (per_iteration_ms * 1e-3)
