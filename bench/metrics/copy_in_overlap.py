"""Copy in overlapped with a replay, %: of the window's ``copy_in`` spans
that carry ``overlapped`` (a graph's copies in of a host input), the
share issued while the graph's stream still ran the previous replay.
None where no ``copy_in`` span carries it (a program without the staged
copy, or the eager walk)."""


def read(ctx):
    if not ctx.spans:
        return None
    ov = [s["overlapped"] for s in ctx.spans
          if s["name"] == "copy_in" and "overlapped" in s]
    return 100.0 * sum(ov) / len(ov) if ov else None
