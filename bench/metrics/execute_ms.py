"""Plan replay per call, ms: the ``execute`` spans of the window (copy
in, graph replay, copy out), mean per call."""


def read(ctx):
    if not ctx.spans:
        return None
    ex = [s["dur_s"] for s in ctx.spans if s["name"] == "execute"]
    return 1e3 * sum(ex) / len(ex) if ex else None
