"""host_enqueue_ms: host time inside the entry call, without a synchronize,
averaged over every call of the trace run's measured window (the profiler is
off there, so its own cost stays out)."""


def read(ctx):
    enq = ctx.window.enqueue_s
    if not enq:
        return None
    return sum(enq) / len(enq) * 1e3
