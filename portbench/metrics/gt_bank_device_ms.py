"""gt_bank_device_ms: device time of one call of the gammatone bank. The
kernels' device time in the traced window over the bank calls the traced
steps ran: the traced steps times the calls a step makes, read from the
program's counter ``spectrograms_tpu_torch.erb.gt_calls`` over one more
step, untraced, after the windows (every step of a closed cell runs the
same); ``gt_filtered_samples`` is read over that step too, for
``gt_roofline_pct``. ``--trace 1`` on a card only; None where the program
has no such counter."""

import torch

from harness import inputs

KEY = "gt_calls_per_step"


def measure(ctx):
    if KEY in ctx.extra:
        return
    ctx.extra[KEY] = None
    from spectrograms_tpu_torch import erb

    if (ctx.trace is None or ctx.device.type != "cuda" or ctx.traffic.get("kind") != "closed"
            or not hasattr(erb, "gt_calls") or not hasattr(erb, "gt_filtered_samples")):
        return
    x = inputs.make_pool(dict(ctx.traffic, pool=1), 0, ctx.device)[0]
    calls, samples = erb.gt_calls, erb.gt_filtered_samples
    ctx.system(x)
    torch.cuda.synchronize(ctx.device)
    ctx.extra[KEY] = erb.gt_calls - calls
    ctx.extra["gt_filtered_samples_per_step"] = erb.gt_filtered_samples - samples


def read(ctx):
    measure(ctx)
    calls, tr = ctx.extra.get(KEY), ctx.trace
    if not calls or tr is None or tr.steps == 0:
        return None
    kernels = tr.kernels()
    if not kernels:
        return None
    return sum(d for _, _, _, d in kernels) / (tr.steps * calls) * 1e-3
