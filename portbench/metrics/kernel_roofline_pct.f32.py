"""kernel_roofline_pct.f32: the task's least time on the H100 over the f32
fused kernel's device time per launch in the traced window.

The least time is the larger of the task's operations over 67 TFLOP/s (f32
outside the tensor cores) and its bytes over 3.35 TB/s. The operations and
bytes are the frozen task count of the configuration's reference module
(``f32_task``): the work of the task, whatever route implements it. The
kernel is the one whose name holds the configuration's ``f32_kernel``."""


def read(ctx):
    tr = ctx.trace
    name = ctx.config.get("f32_kernel")
    task = getattr(ctx.reference, "f32_task", None)
    if tr is None or name is None or task is None:
        return None
    launches = tr.kernels(lambda k: name in k and "tier" not in k)
    if not launches:
        return None
    per_launch_s = sum(d for _, _, _, d in launches) / len(launches) * 1e-6
    flops, nbytes = task(ctx.config, ctx.traffic)
    least_s = max(flops / ctx.peak_flops, nbytes / ctx.peak_bytes)
    return 100.0 * least_s / per_launch_s
