"""The cost model's distance from the card, x: the traced window's device
seconds per forward over the selection's predicted seconds per forward
(``PlanServer.stats()["plans"]``' ``predicted_ms``).  Device seconds
are every operation's but the copies between host and device and the
memsets; forwards are counted as ``kernel_roofline`` counts them, the
port's kernel launches over the launches of one forward.  None where
the program reports no prediction or the plan runs none of the port's
kernels."""
import importlib.util
import pathlib


def _port_kernel():
    """``kernel_roofline``'s pattern of the port's kernels."""
    path = pathlib.Path(__file__).with_name("kernel_roofline.py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_kernel_roofline_pattern", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.PORT_KERNEL


def host_copy(name):
    return name.startswith("Memset") or (
        name.startswith("Memcpy") and ("HtoD" in name or "DtoH" in name))


def read(ctx):
    plans = ctx.setup_stats.get("plans")
    if (ctx.device is None or not ctx.kernel_launches_per_forward
            or not plans or len(plans) != 1):
        return None
    predicted_s = next(iter(plans.values()))["predicted_ms"] / 1e3
    port = _port_kernel()
    launches = secs = 0.0
    for name, (n, s) in ctx.device.ops.items():
        if port.search(name):
            launches += n
        if not host_copy(name):
            secs += s
    if not launches or predicted_s <= 0:
        return None
    forwards = launches / ctx.kernel_launches_per_forward
    return secs / forwards / predicted_s
