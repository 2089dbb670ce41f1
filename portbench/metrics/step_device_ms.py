"""step_device_ms: the kernels' device time in the traced window, summed, over
the steps (batches) in it."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.steps == 0:
        return None
    kernels = tr.kernels()
    if not kernels:
        return None
    return sum(d for _, _, _, d in kernels) / tr.steps * 1e-3
