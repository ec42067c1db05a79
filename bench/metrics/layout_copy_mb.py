"""What the served plan copies outside its convs, MB (1e6 bytes) per
image: the served executable's joins (concat nodes) and layout
conversion steps, each element read and written once
(``PlanServer.stats()["plans"]``: ``join_bytes + conversion_bytes`` of
one forward, over its batch).  None where the program reports no plans,
or more than one."""


def read(ctx):
    plans = ctx.setup_stats.get("plans")
    if not plans or len(plans) != 1:
        return None
    p = next(iter(plans.values()))
    return (p["join_bytes"] + p["conversion_bytes"]) / p["batch"] / 1e6
