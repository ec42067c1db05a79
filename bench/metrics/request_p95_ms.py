"""95th percentile of the latency of the requests completed in the traced
window, ms: the tail of the cells whose ``latency_p95_ms`` swings with
the host too widely to hold end to end (as ``latency_p50_ms``)."""
import numpy as np


def read(ctx):
    if not ctx.done:
        return None
    return float(np.percentile([r.end - r.start for r in ctx.done], 95)) * 1e3
