"""upload_ms: host time of a ``FeaturePipeline`` batch's copy to the card
(pinned or pageable), the port's span ``tg.pipeline.upload`` summed over the
program window (``harness/program_window.py``) and divided by its batches.
``--trace 1`` on a card only; None where the program records no such span."""

from harness import program_window as pw

NAME = "tg.pipeline.upload"


def measure(ctx):
    pw.window(ctx)


def read(ctx):
    return pw.per_step_ms(ctx, lambda w: w.span_total_us(NAME) if w.span_count(NAME) else None)
