"""setup_s: seconds from the start of the process to the first timed call
(import, CUDA context, library load or build, plan build, inputs, warm-up)."""


def read(ctx):
    return ctx.setup_s
