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


@pytest.mark.parametrize("name", ["alexnet", "vgg16"])
def test_a_list_without_inputs_is_a_chain(name):
    layers = net(name)
    assert layers[0].inputs == ()
    for a, b in zip(layers, layers[1:]):
        assert b.inputs == (a.name,) and b.in_shape == a.out_shape


#: two branches off a ReLU of the image, joined on the channels, a padded
#: pool, the global average pool and a classifier
DAG = [
    {"op": "relu", "name": "stem"},
    {"op": "conv", "name": "left", "m": 2, "k": 1, "inputs": ["stem"]},
    {"op": "maxpool", "name": "rpool", "k": 3, "stride": 1, "pad": 1,
     "inputs": ["stem"]},
    {"op": "conv", "name": "right", "m": 3, "k": 1},
    {"op": "concat", "name": "join", "inputs": ["left", "right"]},
    {"op": "maxpool", "name": "down", "k": 3, "stride": 2, "pad": 1},
    {"op": "gap", "name": "gap"},
    {"op": "fc", "name": "fc", "features": 3},
    {"op": "softmax", "name": "prob"},
]


def test_a_branching_list():
    layers = by_name(work.layers(DAG, (4, 8, 8)))
    assert {n: (l.inputs, l.in_shape, l.out_shape)
            for n, l in layers.items()} == {
        "stem": ((), (4, 8, 8), (4, 8, 8)),
        "left": (("stem",), (4, 8, 8), (2, 8, 8)),
        "rpool": (("stem",), (4, 8, 8), (4, 8, 8)),
        "right": (("rpool",), (4, 8, 8), (3, 8, 8)),
        "join": (("left", "right"), (5, 8, 8), (5, 8, 8)),
        # (8 + 2 - 3) // 2 + 1; unpadded it would be 3
        "down": (("join",), (5, 8, 8), (5, 4, 4)),
        "gap": (("down",), (5, 4, 4), (5, 1, 1)),
        "fc": (("gap",), (5, 1, 1), (3, 1, 1)),
        "prob": (("fc",), (3, 1, 1), (3, 1, 1)),
    }
    # 1x1 convolutions: direct is the fewest; 64 outputs x C x M
    assert (layers["left"].least, layers["left"].params) == (64 * 4 * 2, 10)
    assert (layers["right"].least, layers["right"].params) == (64 * 4 * 3, 15)
    assert (layers["fc"].least, layers["fc"].params) == (15, 18)
    assert work.totals(layers.values()) == {"direct": 512 + 768 + 15,
                                            "least": 512 + 768 + 15,
                                            "params": 10 + 15 + 18}
    assert all(layers[n].bytes_at(2) == 0 for n in ("join", "down", "gap"))


@pytest.mark.parametrize("bad, says", [
    ({"op": "relu", "name": "r", "inputs": ["nowhere"]}, "'nowhere'"),
    ({"op": "relu", "name": "r", "inputs": ["later"]}, "'later'"),
    ({"op": "concat", "name": "r", "inputs": ["stem", "down"]}, "one plane"),
    ({"op": "concat", "name": "r", "inputs": ["stem"]}, "two or more"),
    ({"op": "relu", "name": "r", "inputs": ["stem", "down"]}, "one input"),
    ({"op": "dropout", "name": "r"}, "unknown layer op 'dropout'"),
    ({"op": "relu", "name": "down"}, "an earlier layer"),
])
def test_a_bad_entry_is_refused_by_name(bad, says):
    spec = DAG[:6] + [bad, {"op": "relu", "name": "later"}]
    with pytest.raises(ValueError, match=f"layer '{bad['name']}'") as e:
        work.layers(spec, (4, 8, 8))
    assert says in str(e.value)


def test_the_reference_follows_the_branches():
    """The reference on the branching list against the same library calls
    written out by hand: a pool's padding reads as -inf."""
    import torch
    import torch.nn.functional as F
    from reference import sequential
    x = torch.randn(2, 4, 8, 8, generator=torch.Generator().manual_seed(3))
    params = sequential.to_device(sequential.init_params(DAG, (4, 8, 8), 11),
                                  "cpu")
    p = dict(zip([s["name"] for s in DAG], params))
    stem = F.relu(x)
    left = F.conv2d(stem, p["left"]["w"], p["left"]["b"])
    right = F.conv2d(F.max_pool2d(stem, 3, 1, 1), p["right"]["w"],
                     p["right"]["b"])
    y = F.max_pool2d(torch.cat([left, right], 1), 3, 2, 1)
    y = y.mean(dim=(2, 3)) @ p["fc"]["w"] + p["fc"]["b"]
    want = torch.softmax(y, dim=1)
    got = sequential.forward(DAG, params, x)
    assert torch.equal(got, want)
    assert p["right"]["w"].shape == (3, 4, 1, 1)
    assert p["fc"]["w"].shape == (5, 3)
