"""The benchmark's yardstick: operations and bytes of a network, from its shapes.

A convolution's work is the fewest multiply-adds that any algorithm
family of the port's primitive library needs for its shape, so that the
count stays the same whatever implements the layer, and no plan the
library can build reads above its peak:

- direct (and im2col, kn2row): every output times every tap, C * K * K;
- 2-D Winograd F(m, K), stride 1, K = 3 (m = 2, 4, 6) or K = 5 (m = 2, 4):
  the elementwise products over the padded tiles, ceil(OH / m) *
  ceil(OW / m) * (m + K - 1)^2 per channel pair;
- 1-D Winograd F(m, K) along W, stride 1: K * OH * ceil(OW / m) *
  (m + K - 1) per channel pair;
- FFT: the frequency-domain products, one complex multiply-add (four
  real ones) per bin of the real transform per channel pair, over the
  2-D transform of the padded input (any stride: the strided variant
  computes the full convolution and subsamples it), or over the K row
  transforms of the 1-D variant (stride 1).

The transforms themselves are not counted.  Fully connected layers count
as dense products; pooling, activations, LRN, softmax and channel
concatenation count nothing.
Flops are twice the multiply-adds.  Bytes are each input, weight and
output read or written once per call.  Plain Python: no import of the
program.
"""
from __future__ import annotations

import json
import math
import pathlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

#: the 2-D Winograd output tiles of the library, per kernel size
WINO_TILES = {3: (2, 4, 6), 5: (2, 4)}
#: its 1-D Winograd output tiles, per kernel size
WINO1D_TILES = {3: (2, 4), 5: (2, 4)}
F32_BYTES = 4
PEAKS_FILE = pathlib.Path(__file__).resolve().parent / "peaks.json"


@dataclass(frozen=True)
class Layer:
    """One layer of a network with its shapes: ``in_shape`` and
    ``out_shape`` are per image, (C, H, W); a concat's ``in_shape`` is
    its inputs' taken together, as its output."""
    name: str
    op: str
    in_shape: Tuple[int, int, int]
    out_shape: Tuple[int, int, int]
    spec: Dict
    #: multiply-adds per image: direct, and the fewest of any family
    direct: int = 0
    least: int = 0
    #: the family that needs the fewest
    family: str = ""
    #: parameters (weights and biases)
    params: int = 0
    #: the names of the layers whose outputs it takes; () for the image
    inputs: Tuple[str, ...] = ()

    def bytes_at(self, n: int) -> int:
        """Bytes of one call at batch ``n``: input, weights, output."""
        if not self.params:
            return 0
        return F32_BYTES * (n * math.prod(self.in_shape) + self.params
                            + n * math.prod(self.out_shape))


def conv_out(h: int, k: int, stride: int, pad: int) -> int:
    return (h + 2 * pad - k) // stride + 1


def conv_macs(c: int, h: int, w: int, m: int, k: int, stride: int,
              pad: int) -> Dict[str, int]:
    """Multiply-adds per image of each family that supports the shape."""
    oh, ow = conv_out(h, k, stride, pad), conv_out(w, k, stride, pad)
    cm = c * m
    out = {"direct": oh * ow * cm * k * k}
    hp, wp = h + 2 * pad, w + 2 * pad
    if hp < k or wp < k:
        return out
    fh, fw = hp + k - 1, wp + k - 1
    out["fft2d"] = 4 * cm * fh * (fw // 2 + 1)
    if stride != 1:
        return out
    for t in WINO_TILES.get(k, ()):
        a = t + k - 1
        out[f"wino2d_f{t}x{k}"] = (-(-oh // t)) * (-(-ow // t)) * a * a * cm
    for t in WINO1D_TILES.get(k, ()):
        out[f"wino1d_f{t}x{k}"] = k * oh * (-(-ow // t)) * (t + k - 1) * cm
    out["fft1d"] = 4 * cm * k * oh * (fw // 2 + 1)
    return out


def layers(spec: Sequence[Dict], in_shape: Sequence[int]) -> List[Layer]:
    """Each layer of a configuration's ``layers`` list with its shapes and
    counts, from the input shape (C, H, W).

    An entry takes the outputs of the earlier entries that its
    ``"inputs"`` names; without the key, the output of the entry before
    it (the first entry: the image), so a list without ``inputs`` is a
    chain.  A ``concat`` joins two or more inputs of one plane along the
    channels; every other op takes one input.  An entry with an unknown
    op, a name taken before, an input that is no earlier entry's name, or
    inputs that its op cannot take raises ``ValueError`` naming it."""
    image = tuple(int(v) for v in in_shape)
    out: List[Layer] = []
    shapes: Dict[str, Tuple[int, int, int]] = {}
    for i, s in enumerate(spec):
        op, name = s["op"], s.get("name", f"{s['op']}{i}")
        if name in shapes:
            raise ValueError(f"layer {name!r}: the name of an earlier layer")
        if "inputs" in s:
            inputs = tuple(s["inputs"])
            for x in inputs:
                if x not in shapes:
                    raise ValueError(f"layer {name!r}: input {x!r} is no "
                                     f"earlier layer's name")
            ins = [shapes[x] for x in inputs]
        elif out:
            inputs, ins = (out[-1].name,), [out[-1].out_shape]
        else:
            inputs, ins = (), [image]
        if op == "concat":
            if len(ins) < 2 or len({x[1:] for x in ins}) != 1:
                raise ValueError(f"layer {name!r}: concat takes two or more "
                                 f"inputs of one plane, not {ins}")
            shape = (sum(x[0] for x in ins),) + ins[0][1:]
        elif len(ins) != 1:
            raise ValueError(f"layer {name!r}: {op} takes one input, "
                             f"not {len(ins)}")
        else:
            shape = ins[0]
        c, h, w = shape
        direct = least = params = 0
        family = ""
        if op == "conv":
            k, st, p, m = s["k"], s.get("stride", 1), s.get("pad", 0), s["m"]
            new = (m, conv_out(h, k, st, p), conv_out(w, k, st, p))
            macs = conv_macs(c, h, w, m, k, st, p)
            direct = macs["direct"]
            family = min(macs, key=lambda f: (macs[f], f))
            least = macs[family]
            params = m * c * k * k + m
        elif op == "fc":
            n_in, f = c * h * w, s["features"]
            new = (f, 1, 1)
            direct = least = n_in * f
            family = "dense"
            params = n_in * f + f
        elif op == "maxpool":
            k, st, p = s["k"], s["stride"], s.get("pad", 0)
            new = (c, conv_out(h, k, st, p), conv_out(w, k, st, p))
        elif op == "gap":
            new = (c, 1, 1)
        elif op in ("relu", "lrn", "softmax", "concat"):
            new = shape
        else:
            raise ValueError(f"layer {name!r}: unknown layer op {op!r}")
        out.append(Layer(name, op, shape, new, dict(s), direct, least,
                         family, params, inputs))
        shapes[name] = new
    return out


def totals(ls: Sequence[Layer]) -> Dict[str, int]:
    """Per image: direct and least multiply-adds, and parameters."""
    return {"direct": sum(l.direct for l in ls),
            "least": sum(l.least for l in ls),
            "params": sum(l.params for l in ls)}


def bound_s(layer: Layer, n: int, peak: Dict[str, float]) -> float:
    """The least time of one call of ``layer`` at batch ``n``: the larger
    of its least flops over the peak rate and its bytes over the memory
    bandwidth."""
    return max(2 * layer.least * n / peak["flops"],
               layer.bytes_at(n) / peak["bytes_per_s"])


def peak_of(device_name: str) -> Optional[Dict[str, float]]:
    """The published f32 peaks of a device by its CUDA name (None: not in
    the table)."""
    table = json.loads(PEAKS_FILE.read_text())
    return table.get(device_name)
