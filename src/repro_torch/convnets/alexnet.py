"""AlexNet (Krizhevsky et al. 2012), single-tower Caffe topology.

``scale`` shrinks the input resolution (227 -> 227*scale) for fast
CI-scale runs; scale=1.0 is the paper's benchmark configuration.
"""
from __future__ import annotations

from ..core.graph import Net, fc, lrn, maxpool, relu, softmax


def alexnet(scale: float = 1.0) -> Net:
    r = max(int(227 * scale), 35)
    net = Net(f"alexnet{'' if scale == 1.0 else f'@{r}'}")
    x = net.input("data", (3, r, r))
    x = net.conv("conv1", x, k=11, m=96, stride=4, pad=0)
    x = net.op("relu1", [x], relu())
    x = net.op("norm1", [x], lrn())
    x = net.op("pool1", [x], maxpool(3, 2))
    x = net.conv("conv2", x, k=5, m=256, pad=2)
    x = net.op("relu2", [x], relu())
    x = net.op("norm2", [x], lrn())
    x = net.op("pool2", [x], maxpool(3, 2))
    x = net.conv("conv3", x, k=3, m=384, pad=1)
    x = net.op("relu3", [x], relu())
    x = net.conv("conv4", x, k=3, m=384, pad=1)
    x = net.op("relu4", [x], relu())
    x = net.conv("conv5", x, k=3, m=256, pad=1)
    x = net.op("relu5", [x], relu())
    x = net.op("pool5", [x], maxpool(3, 2))
    x = net.op("fc6", [x], fc(4096, relu_after=True))
    x = net.op("fc7", [x], fc(4096, relu_after=True))
    x = net.op("fc8", [x], fc(1000))
    net.op("prob", [x], softmax())
    return net
