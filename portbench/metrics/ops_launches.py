"""ops_launches: CUDA kernel launch calls made inside the port's
``tg.op.*`` spans (the innermost span open on the calling thread), over the
steps of the program window (``harness/program_window.py``). ``--trace 1``
on a card only; None where the program records no span."""

from harness import program_window as pw


def measure(ctx):
    pw.window(ctx)


def read(ctx):
    w = pw.window(ctx)
    if w is None or not w.has_program_spans or w.steps == 0:
        return None
    return w.launches_in("tg.op.") / w.steps
