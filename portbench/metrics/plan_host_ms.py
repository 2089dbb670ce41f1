"""plan_host_ms: host self time of the plans and entry points, the port's
spans ``tg.plan.*`` and ``tg.member.*`` less the spans nested in them (the
checks, the autograd function, the feature set's loop), summed over the
program window (``harness/program_window.py``) and divided by its steps.
``--trace 1`` on a card only; None where the program records no span."""

from harness import program_window as pw


def measure(ctx):
    pw.window(ctx)


def read(ctx):
    return pw.per_step_ms(ctx, lambda w: w.self_us("tg.plan.", "tg.member."))
