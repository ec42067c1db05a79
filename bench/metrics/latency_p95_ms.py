"""95th percentile of the latency of the requests completed in the
window, ms (as ``latency_p50_ms``)."""
import numpy as np


def read(ctx):
    if not ctx.done:
        return None
    return float(np.percentile([r.end - r.start for r in ctx.done], 95)) * 1e3
