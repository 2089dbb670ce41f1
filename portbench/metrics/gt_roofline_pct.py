"""gt_roofline_pct: the least time of one call of the gammatone bank on the
H100 over ``gt_bank_device_ms``, the device time one call took.

The least time is the larger of the call's operations over 67 TFLOP/s
(H100 SXM, float64 on the tensor cores and float32 outside them, data
sheet) and its bytes over 3.35 TB/s. The counts are the frozen task count of
the configuration's reference module (``gt_task``). None wherever
``gt_bank_device_ms`` is, and where the samples the program filtered a call
(counter ``erb.gt_filtered_samples``) differ from the task's
(``filtered_samples``): a route that skips work does not raise it."""

from pathlib import Path

from harness.manifest import load_module

_bank = load_module(Path(__file__).with_name("gt_bank_device_ms.py"), "metric")


def measure(ctx):
    _bank.measure(ctx)


def read(ctx):
    per_call_ms = _bank.read(ctx)
    task = getattr(ctx.reference, "gt_task", None)
    count = getattr(ctx.reference, "filtered_samples", None)
    if per_call_ms is None or task is None or count is None:
        return None
    calls = ctx.extra.get(_bank.KEY)
    filtered = ctx.extra.get("gt_filtered_samples_per_step")
    if not calls or filtered is None or filtered != calls * count(ctx.config, ctx.traffic):
        return None
    flops, nbytes = task(ctx.config, ctx.traffic)
    least_s = max(flops / ctx.peak_flops, nbytes / ctx.peak_bytes)
    return 100.0 * least_s / (per_call_ms * 1e-3)
