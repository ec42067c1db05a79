"""Shape-parameterized demo networks for the plan server.

A :class:`~repro.serving.server.PlanServer` needs a *net builder*: a
callable mapping a bucket shape (C, H, W) to a :class:`~repro.core.
graph.Net`.  Any of the paper's networks work (``lambda s: vgg("A")``
ignores the shape); these small towers are sized for tests, examples and
the vision-token bridge in the LM serving loop, where compiling VGG per
bucket would dominate the demo.

Crucially, the builder must return the *same node ids* for every shape —
that is what lets the server warm-start a new bucket's PBQP solve from a
neighbouring bucket's optimum.
"""
from __future__ import annotations

from typing import Tuple

from ..core.graph import Net, fc, global_avgpool, maxpool, relu

__all__ = ["conv_tower", "conv_stack", "uniform_stack",
           "bottleneck_tower"]


def conv_tower(shape_chw: Tuple[int, int, int], *, depth: int = 3,
               width: int = 16, k: int = 3, features: int = 64) -> Net:
    """A small conv/relu/pool tower ending in a feature vector.

    Channel width doubles per stage; spatial size halves per stage.  For
    inputs with ``min(h, w) >= 2**depth`` (guarantee it via the bucket
    policy's ``min_hw``) node ids depend only on ``depth``, never on the
    input shape, so selections for neighbouring buckets line up; smaller
    inputs drop the trailing pools (and warm starts degrade to cold
    solves, which is correct, just slower).
    """
    c, h, w = shape_chw
    net = Net(f"tower{depth}w{width}")
    x = net.input("data", (c, h, w))
    for i in range(depth):
        m = width << i
        x = net.conv(f"conv{i}", x, k=k, m=m, pad=k // 2)
        x = net.op(f"relu{i}", [x], relu())
        _, ch, cw = net.nodes[x].out_shape
        if min(ch, cw) >= 2:  # pool whenever legal (2x2, stride 2)
            x = net.op(f"pool{i}", [x], maxpool(2, 2))
    x = net.op("gap", [x], global_avgpool())
    net.op("feat", [x], fc(features))
    return net


def conv_stack(shape_chw: Tuple[int, int, int], *, depth: int = 2,
               width: int = 8, k: int = 3) -> Net:
    """A conv/relu stack that *keeps spatial extent* (stride 1, "same"
    pad, no pooling/GAP/FC).

    Its outputs are (M, H, W) feature maps, which makes it the right
    fixture for everything that reasons about spatial cropping: a
    request zero-padded into its bucket produces, after cropping, the
    same values as a run at the request's own shape (weights depend only
    on (C, K, M), so bucket-net and request-net share them when C
    matches).  Also the throughput fixture for the batched-serving
    benchmark, where global ops would hide the conv work.
    """
    c, h, w = shape_chw
    net = Net(f"stack{depth}w{width}")
    x = net.input("data", (c, h, w))
    for i in range(depth):
        m = width << i
        x = net.conv(f"conv{i}", x, k=k, m=m, pad=k // 2)
        x = net.op(f"relu{i}", [x], relu())
    return net


def uniform_stack(shape_chw: Tuple[int, int, int], *, depth: int = 4,
                  k: int = 3) -> Net:
    """A *shape-preserving* conv/relu chain: every layer maps
    ``(C, H, W) -> (C, H, W)`` (``m == c``, stride 1, "same" pad).

    This is the pipelineable fixture: a single linear chain whose
    activations all share one shape, which is exactly what
    :func:`~repro.core.selection.pp_chain` demands — the pipeline
    executor rotates a fixed-shape carry between stages.  The pp
    placement axis is only ever *offered* on nets like this one.
    """
    c, h, w = shape_chw
    net = Net(f"uniform{depth}c{c}")
    x = net.input("data", (c, h, w))
    for i in range(depth):
        x = net.conv(f"conv{i}", x, k=k, m=c, pad=k // 2)
        x = net.op(f"relu{i}", [x], relu())
    return net


def bottleneck_tower(shape_chw: Tuple[int, int, int], *,
                     head_depth: int = 3, head_width: int = 8,
                     body_depth: int = 2, body_width: int = 512,
                     k: int = 3) -> Net:
    """A tower built to exceed one device's arithmetic-intensity sweet
    spot: a thin widening head shrinks the spatial extent to 1x1, then
    fat ``body_width``-channel convs run at 1x1 spatial — each body
    layer streams a ``body_width^2 k^2`` weight tensor over almost no
    activations, so it is *weight-bandwidth* bound.  dp replicates
    those weights on every device and gains nothing; tp shards them
    ``D_tp`` ways and cuts the per-device traffic by the same factor —
    the mixed tp+dp-beats-pure-dp headline fixture of
    ``benchmarks/bench_parallelism.py``.
    """
    c, h, w = shape_chw
    net = Net(f"bottleneck{head_depth}x{body_depth}w{body_width}")
    x = net.input("data", (c, h, w))
    for i in range(head_depth):
        m = head_width << i
        x = net.conv(f"head{i}", x, k=k, m=m, pad=k // 2)
        x = net.op(f"hrelu{i}", [x], relu())
        _, ch, cw = net.nodes[x].out_shape
        if min(ch, cw) >= 2:
            x = net.op(f"hpool{i}", [x], maxpool(2, 2))
    # crush whatever spatial extent remains to 1x1
    _, ch, cw = net.nodes[x].out_shape
    if min(ch, cw) >= 2:
        x = net.op("crush", [x], maxpool(min(ch, cw), min(ch, cw)))
    for i in range(body_depth):
        x = net.conv(f"body{i}", x, k=k, m=body_width, pad=k // 2)
        x = net.op(f"brelu{i}", [x], relu())
    return net
