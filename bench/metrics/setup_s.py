"""Seconds from the harness's start to the window's: imports, kernel
libraries (built on a checkout's first run), weights, the PBQP solve,
weight packing and CUDA-graph capture, and the warm-up requests."""


def read(ctx):
    return ctx.setup_s
