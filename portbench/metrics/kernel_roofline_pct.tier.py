"""kernel_roofline_pct.tier: the task's least time on the H100 over the tier
kernel's device time per launch in the traced window.

The least time is the largest of the task's product operations over 989.4
TFLOP/s (bf16 dense on the tensor cores), its elementwise operations over
67 TFLOP/s (f32 outside the tensor cores) and its bytes over 3.35 TB/s (all
H100 SXM, data sheet). The counts are the frozen task count of the
configuration's reference module (``tier_task``). The kernel is the one
whose name holds the configuration's ``tier_kernel``."""

PEAK_BF16_FLOPS = 989.4e12


def read(ctx):
    tr = ctx.trace
    name = ctx.config.get("tier_kernel")
    task = getattr(ctx.reference, "tier_task", None)
    if tr is None or name is None or task is None:
        return None
    launches = tr.kernels(lambda k: name in k)
    if not launches:
        return None
    per_launch_s = sum(d for _, _, _, d in launches) / len(launches) * 1e-6
    products, elementwise, nbytes = task(ctx.config, ctx.traffic)
    least_s = max(products / PEAK_BF16_FLOPS, elementwise / ctx.peak_flops,
                  nbytes / ctx.peak_bytes)
    return 100.0 * least_s / per_launch_s
