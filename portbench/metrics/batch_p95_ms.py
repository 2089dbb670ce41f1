"""batch_p95_ms: the 95th percentile, over every batch of the measured window,
of the host time from the call into the entry to the return of the
``torch.cuda.synchronize()`` after it (closed loop, one batch in flight)."""

import numpy as np


def read(ctx):
    lat = ctx.window.latencies_s
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95.0)) * 1e3
