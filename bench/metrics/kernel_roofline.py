"""The port's own kernels' share of their roofline, %, in the traced
window: the least time of the convolutions the plan gives them
(``bench/work.py``: the larger of least flops over the f32 peak and
bytes over the HBM bandwidth, per call at the executable's batch), for
as many forwards as their launches make, over the device time of those
launches.  None where the plan runs none of the port's kernels."""
import re

#: the port's kernels (``src/repro_torch/csrc``) by their device names
PORT_KERNEL = re.compile(
    r"repro::sm90::|\(anonymous namespace\)::"
    r"(conv_kernel|flash_kernel|short_rows_kernel|short_cols_kernel|"
    r"tile_kernel)\b")


def read(ctx):
    if ctx.device is None or not ctx.kernel_launches_per_forward:
        return None
    launches = secs = 0
    for name, (n, s) in ctx.device.ops.items():
        if PORT_KERNEL.search(name):
            launches += n
            secs += s
    if secs <= 0:
        return None
    forwards = launches / ctx.kernel_launches_per_forward
    return 100.0 * forwards * ctx.kernel_bound_s / secs
