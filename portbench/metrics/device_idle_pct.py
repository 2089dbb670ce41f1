"""device_idle_pct: share of the traced window in which no device operation
(kernel, copy or memset) runs: the union of their intervals against the
window, from the first harness span's start to the last one's end."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_us <= 0 or not tr.kernels():
        return None
    return 100.0 * (1.0 - tr.busy_us() / tr.window_us)
