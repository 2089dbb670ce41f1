"""launch_host_ms: host self time of the CUDA kernels' launches, the port's
spans ``tg.kernel.<source>`` (layout, output allocation, the library call)
summed over the program window (``harness/program_window.py``) and divided
by its steps. The spans are held against the kernels' ``.launches``
counters over the same loop: where their numbers differ the metric is
None. ``--trace 1`` on a card only; None where the program records no span."""

import sys

from harness import program_window as pw


def measure(ctx):
    pw.window(ctx)


def read(ctx):
    w = pw.window(ctx)
    if w is None or not w.has_program_spans:
        return None
    spans = w.span_count("tg.kernel.")
    if spans != w.counted_launches:
        print(f"portbench: launch_host_ms: {spans} tg.kernel spans against "
              f"{w.counted_launches} counted launches", file=sys.stderr)
        return None
    return pw.per_step_ms(ctx, lambda w: w.self_us("tg.kernel."))
