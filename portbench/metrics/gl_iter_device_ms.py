"""gl_iter_device_ms: device time of one Griffin-Lim iteration. The kernels'
device time in the traced window less the configuration's ``f32_kernel``
(the mel analysis), over the iterations the traced steps ran: the traced
steps times the iterations a step runs, read from the program's counter
``spectrograms_tpu_torch.reconstruct.gl_iterations`` over one more step,
untraced, after the windows (every step of a closed cell runs the same).
``--trace 1`` on a card only; None where the program has no such counter."""

import torch

from harness import inputs

KEY = "gl_iterations_per_step"


def measure(ctx):
    if KEY in ctx.extra:
        return
    ctx.extra[KEY] = None
    from spectrograms_tpu_torch import reconstruct

    if (ctx.trace is None or ctx.device.type != "cuda" or ctx.traffic.get("kind") != "closed"
            or not hasattr(reconstruct, "gl_iterations")):
        return
    x = inputs.make_pool(dict(ctx.traffic, pool=1), 0, ctx.device)[0]
    before = reconstruct.gl_iterations
    ctx.system(x)
    torch.cuda.synchronize(ctx.device)
    ctx.extra[KEY] = reconstruct.gl_iterations - before


def read(ctx):
    measure(ctx)
    iterations, tr = ctx.extra.get(KEY), ctx.trace
    if not iterations or tr is None or tr.steps == 0:
        return None
    name = ctx.config.get("f32_kernel")
    kernels = tr.kernels(lambda k: not (name and name in k))
    if not kernels:
        return None
    return sum(d for _, _, _, d in kernels) / (tr.steps * iterations) * 1e-3
