"""The work count against hand-worked values (``bench/work.py``)."""
import json
import pathlib
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

import work  # noqa: E402


def net(name):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    return work.layers(cfg["layers"], cfg["input"])


def by_name(layers):
    return {l.name: l for l in layers}


def test_alexnet_conv3_direct_and_least():
    # 13 x 13 x 384 outputs of 256 x 3 x 3 taps; F(4,3) or F(6,3) on
    # padded tiles: 16 tiles of 36 or 9 of 64 products, 576 a channel pair
    conv3 = by_name(net("alexnet"))["conv3"]
    assert conv3.direct == 13 * 13 * 384 * 256 * 9 == 149_520_384
    assert conv3.least == 576 * 256 * 384 == 56_623_104


def test_alexnet_fft_convs():
    # conv1 (stride 4): the 2-D transform of the 227 x 227 input, 237 x
    # 119 bins; conv2: 35 x 18 bins against F(4,5)'s 49 tiles of 64
    layers = by_name(net("alexnet"))
    assert layers["conv1"].least == 4 * 3 * 96 * 237 * 119 == 32_489_856
    assert layers["conv1"].family == "fft2d"
    assert layers["conv2"].least == 4 * 96 * 256 * 35 * 18 == 61_931_520
    assert 4 * 35 * 18 < 49 * 64


@pytest.mark.parametrize("name, direct, least, params", [
    ("alexnet", 1_135_256_096, 351_224_192, 62_378_344),
    ("vgg16", 15_470_264_320, 3_637_854_208, 138_357_544),
])
def test_network_totals(name, direct, least, params):
    t = work.totals(net(name))
    assert (t["direct"], t["least"], t["params"]) == (direct, least, params)


def test_direct_and_winograd_alone_count_0_439_g():
    # without the FFT family AlexNet's least count is 0.439 G
    total = 0
    for l in net("alexnet"):
        if l.op == "conv":
            c, h, w = l.in_shape
            s = l.spec
            macs = work.conv_macs(c, h, w, s["m"], s["k"], s.get("stride", 1),
                                  s.get("pad", 0))
            total += min(v for f, v in macs.items()
                         if f == "direct" or f.startswith("wino2d"))
        else:
            total += l.least
    assert round(total / 1e9, 3) == 0.439


@pytest.mark.parametrize("name", ["alexnet", "vgg16"])
def test_no_count_exceeds_direct(name):
    for l in net(name):
        assert 0 <= l.least <= l.direct


@pytest.mark.parametrize("c, h, m, k, stride, pad", [
    (3, 224, 64, 3, 1, 1), (64, 7, 64, 3, 1, 1), (16, 5, 8, 5, 1, 2),
    (32, 31, 16, 1, 1, 0), (8, 64, 8, 7, 2, 3), (4, 9, 4, 3, 2, 0),
    (1, 3, 1, 3, 1, 0)])
def test_least_of_any_shape_is_at_most_direct(c, h, m, k, stride, pad):
    macs = work.conv_macs(c, h, h, m, k, stride, pad)
    assert min(macs.values()) <= macs["direct"]
    assert all(v > 0 for v in macs.values())


def test_bound_is_the_larger_of_flops_and_bytes():
    peak = {"flops": 67e12, "bytes_per_s": 3.35e12}
    conv3 = by_name(net("alexnet"))["conv3"]
    b = work.bound_s(conv3, 8, peak)
    assert b == max(2 * conv3.least * 8 / 67e12,
                    conv3.bytes_at(8) / 3.35e12)
    assert conv3.bytes_at(1) == 4 * (256 * 13 * 13 + 384 * 256 * 9 + 384
                                     + 384 * 13 * 13)


def test_peak_table():
    assert work.peak_of("NVIDIA H100 80GB HBM3")["flops"] == 67e12
    assert work.peak_of("a card not in the table") is None
