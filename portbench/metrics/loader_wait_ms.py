"""loader_wait_ms: host time a ``FeaturePipeline`` batch waits on the native
loader for its samples, the port's span ``tg.pipeline.loader_wait`` summed
over the program window (``harness/program_window.py``) and divided by its
batches. ``--trace 1`` on a card only; None where the program records no
such span."""

from harness import program_window as pw

NAME = "tg.pipeline.loader_wait"


def measure(ctx):
    pw.window(ctx)


def read(ctx):
    return pw.per_step_ms(ctx, lambda w: w.span_total_us(NAME) if w.span_count(NAME) else None)
