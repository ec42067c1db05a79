"""The whole step's share of the chip's f32 peak, %: the least work of
the images completed in the window (``bench/work.py``, the fewest
multiply-adds of any algorithm family of the library, twice for flops)
over the window at the published peak (``bench/peaks.json``)."""
import work


def read(ctx):
    if ctx.peak is None or not ctx.images:
        return None
    flops = 2 * work.totals(ctx.layers)["least"] * ctx.images
    return 100.0 * flops / (ctx.window_s * ctx.peak["flops"])
