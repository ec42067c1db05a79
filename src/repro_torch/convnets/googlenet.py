"""GoogleNet / Inception-v1 (Szegedy et al. 2015), main tower.

The inception joins are the paper's Figure 3 motivation: concat nodes
with 4 producers whose layout choices must co-adapt — the DAG case where
greedy selection breaks and PBQP shines.
"""
from __future__ import annotations

from ..core.graph import Net, concat, fc, global_avgpool, lrn, maxpool, \
    relu, softmax

# (1x1, 3x3reduce, 3x3, 5x5reduce, 5x5, pool_proj)
_INCEPTION = {
    "3a": (64, 96, 128, 16, 32, 32),
    "3b": (128, 128, 192, 32, 96, 64),
    "4a": (192, 96, 208, 16, 48, 64),
    "4b": (160, 112, 224, 24, 64, 64),
    "4c": (128, 128, 256, 24, 64, 64),
    "4d": (112, 144, 288, 32, 64, 64),
    "4e": (256, 160, 320, 32, 128, 128),
    "5a": (256, 160, 320, 32, 128, 128),
    "5b": (384, 192, 384, 48, 128, 128),
}


def _inception(net: Net, name: str, x: str,
               p1, p3r, p3, p5r, p5, pp) -> str:
    b1 = net.conv(f"i{name}_1x1", x, k=1, m=p1, pad=0)
    b1 = net.op(f"i{name}_relu1", [b1], relu())
    b3 = net.conv(f"i{name}_3x3r", x, k=1, m=p3r, pad=0)
    b3 = net.op(f"i{name}_relu3r", [b3], relu())
    b3 = net.conv(f"i{name}_3x3", b3, k=3, m=p3, pad=1)
    b3 = net.op(f"i{name}_relu3", [b3], relu())
    b5 = net.conv(f"i{name}_5x5r", x, k=1, m=p5r, pad=0)
    b5 = net.op(f"i{name}_relu5r", [b5], relu())
    b5 = net.conv(f"i{name}_5x5", b5, k=5, m=p5, pad=2)
    b5 = net.op(f"i{name}_relu5", [b5], relu())
    bp = net.op(f"i{name}_pool", [x], maxpool(3, 1, pad=1))
    bp = net.conv(f"i{name}_poolproj", bp, k=1, m=pp, pad=0)
    bp = net.op(f"i{name}_relupp", [bp], relu())
    return net.op(f"i{name}_concat", [b1, b3, b5, bp], concat())


def googlenet(scale: float = 1.0) -> Net:
    r = max(int(224 * scale), 32)
    net = Net(f"googlenet{'' if scale == 1.0 else f'@{r}'}")
    x = net.input("data", (3, r, r))
    x = net.conv("conv1", x, k=7, m=64, stride=2, pad=3)
    x = net.op("relu1", [x], relu())
    x = net.op("pool1", [x], maxpool(3, 2, pad=1))
    x = net.op("norm1", [x], lrn())
    x = net.conv("conv2r", x, k=1, m=64, pad=0)
    x = net.op("relu2r", [x], relu())
    x = net.conv("conv2", x, k=3, m=192, pad=1)
    x = net.op("relu2", [x], relu())
    x = net.op("norm2", [x], lrn())
    x = net.op("pool2", [x], maxpool(3, 2, pad=1))
    x = _inception(net, "3a", x, *_INCEPTION["3a"])
    x = _inception(net, "3b", x, *_INCEPTION["3b"])
    x = net.op("pool3", [x], maxpool(3, 2, pad=1))
    x = _inception(net, "4a", x, *_INCEPTION["4a"])
    x = _inception(net, "4b", x, *_INCEPTION["4b"])
    x = _inception(net, "4c", x, *_INCEPTION["4c"])
    x = _inception(net, "4d", x, *_INCEPTION["4d"])
    x = _inception(net, "4e", x, *_INCEPTION["4e"])
    x = net.op("pool4", [x], maxpool(3, 2, pad=1))
    x = _inception(net, "5a", x, *_INCEPTION["5a"])
    x = _inception(net, "5b", x, *_INCEPTION["5b"])
    x = net.op("gap", [x], global_avgpool())
    x = net.op("fc", [x], fc(1000))
    net.op("prob", [x], softmax())
    return net
