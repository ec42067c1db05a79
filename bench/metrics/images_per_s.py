"""Images completed in the window, per second of the window."""


def read(ctx):
    return ctx.images / ctx.window_s
