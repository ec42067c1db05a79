"""The server's host time per call, ms: each ``infer`` or ``infer_batch``
span of the window less its ``execute`` children (bucketing, padding,
stacking, cropping, futures), mean per call."""


def read(ctx):
    if not ctx.spans:
        return None
    child = {}
    for s in ctx.spans:
        if s["name"] == "execute" and s["parent"] is not None:
            child[s["parent"]] = child.get(s["parent"], 0.0) + s["dur_s"]
    calls = [s["dur_s"] - child.get(s["span"], 0.0) for s in ctx.spans
             if s["name"] in ("infer", "infer_batch")]
    return 1e3 * sum(calls) / len(calls) if calls else None
