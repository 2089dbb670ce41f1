"""idle_in_program_pct: share of the device's idle time in the program
window (``harness/program_window.py``) during which the innermost span open
on the harness's thread is one of the port's ``tg.*`` spans: idle time the
program's own host work holds, against the harness's. ``--trace 1`` on a
card only; None where the program records no span."""

from harness import program_window as pw


def measure(ctx):
    pw.window(ctx)


def read(ctx):
    w = pw.window(ctx)
    if w is None or not w.has_program_spans:
        return None
    share = w.idle_in_program_share()
    return None if share is None else 100.0 * share
