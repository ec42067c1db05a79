"""The device's idle share of the traced window, %: the time in which no
kernel, copy or set ran (``torch.profiler``)."""


def read(ctx):
    if ctx.device is None or ctx.device.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.device.busy_s / ctx.device.window_s)
