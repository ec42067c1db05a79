"""Copy in per call, ms: the ``copy_in`` spans of the window (the numpy
array made a tensor and copied into the graph's static input, a
pageable host-to-device copy), mean per call.  None where the program
writes no such span."""


def read(ctx):
    if not ctx.spans:
        return None
    d = [s["dur_s"] for s in ctx.spans if s["name"] == "copy_in"]
    return 1e3 * sum(d) / len(d) if d else None
