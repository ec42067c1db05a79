"""Seconds of compiling in set-up: weights, packing and the CUDA-graph
capture of the cell's executable (``PlanServer.stats()``)."""


def read(ctx):
    return ctx.setup_stats["compile_s"]
