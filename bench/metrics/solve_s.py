"""Seconds of PBQP solving in set-up (``PlanServer.stats()``)."""


def read(ctx):
    return ctx.setup_stats["solve_s"]
