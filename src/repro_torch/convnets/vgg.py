"""VGG configurations A-E (Simonyan & Zisserman 2014, Table 1).

The paper benchmarks VGG-A..E; C includes the 1x1 convolutions.  Models
other than D/E were reconstructed by hand "exactly following" the
publication — as are these.
"""
from __future__ import annotations

from ..core.graph import Net, fc, maxpool, relu, softmax

# stage channel plans; "1" suffix marks the 1x1 convs of config C
_CFG = {
    "A": [[64], [128], [256, 256], [512, 512], [512, 512]],
    "B": [[64, 64], [128, 128], [256, 256], [512, 512], [512, 512]],
    "C": [[64, 64], [128, 128], [256, 256, "256x1"],
          [512, 512, "512x1"], [512, 512, "512x1"]],
    "D": [[64, 64], [128, 128], [256, 256, 256], [512, 512, 512],
          [512, 512, 512]],
    "E": [[64, 64], [128, 128], [256, 256, 256, 256],
          [512, 512, 512, 512], [512, 512, 512, 512]],
}


def vgg(cfg: str = "D", scale: float = 1.0) -> Net:
    cfg = cfg.upper()
    r = max(int(224 * scale), 32)
    net = Net(f"vgg-{cfg.lower()}{'' if scale == 1.0 else f'@{r}'}")
    x = net.input("data", (3, r, r))
    for si, stage in enumerate(_CFG[cfg], start=1):
        for ci, spec in enumerate(stage, start=1):
            if isinstance(spec, str):  # C's 1x1 convs
                m = int(spec.split("x")[0])
                k, pad = 1, 0
            else:
                m, k, pad = spec, 3, 1
            x = net.conv(f"conv{si}_{ci}", x, k=k, m=m, pad=pad)
            x = net.op(f"relu{si}_{ci}", [x], relu())
        x = net.op(f"pool{si}", [x], maxpool(2, 2))
    x = net.op("fc6", [x], fc(4096, relu_after=True))
    x = net.op("fc7", [x], fc(4096, relu_after=True))
    x = net.op("fc8", [x], fc(1000))
    net.op("prob", [x], softmax())
    return net
