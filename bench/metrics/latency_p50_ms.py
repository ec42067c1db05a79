"""Median latency of the requests completed in the window, ms: from the
call (``infer``, ``infer_batch``) or the submission (``submit``) to the
answer back on the host."""
import numpy as np


def read(ctx):
    if not ctx.done:
        return None
    return float(np.percentile([r.end - r.start for r in ctx.done], 50)) * 1e3
