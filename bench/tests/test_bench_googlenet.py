"""A branching network through the harness: GoogLeNet's layer list, written
here from Szegedy et al. 2015 (arXiv:1409.4842), Table 1, in the order of
the program's ``googlenet`` net, goes through ``work.layers``, the
reference and ``cell.run`` with no file of the benchmark edited.

``googlenet_spec`` is also the in-memory cell that a probe on the card
runs (``cell.run`` with ``cell.load_spec`` patched to return it)."""
import copy
import json
import pathlib
import sys
import time

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(ROOT / "src"), str(BENCH)]

import work  # noqa: E402
from test_bench_harness import (  # noqa: E402
    assert_draws_the_programs_weights, roll_classes)

#: Table 1's inception modules: #1x1, #3x3 reduce, #3x3, #5x5 reduce,
#: #5x5, pool proj
INCEPTION = {
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
LRN = {"size": 5, "alpha": 0.0001, "beta": 0.75, "bias": 1.0}
#: the smallest scale whose every layer keeps a pixel (33 px)
CPU_SCALE = 0.15


def googlenet_layers():
    """GoogLeNet's layers by the program's node names: 3x3/2 max pools
    padded by 1 (56, 28, 14, 7 px at 224), a global average pool in
    place of Table 1's 7x7 average pool, no dropout (inference)."""
    out = []

    def add(op, name, inputs=None, **kw):
        out.append({"op": op, "name": name, **kw,
                    **({"inputs": inputs} if inputs else {})})
        return name

    def conv(name, m, k, relu, stride=1, pad=0, inputs=None):
        add("conv", name, inputs, m=m, k=k, stride=stride, pad=pad)
        return add("relu", relu)

    def inception(x, i, p1, p3r, p3, p5r, p5, pp):
        b1 = conv(f"i{i}_1x1", p1, 1, f"i{i}_relu1", inputs=[x])
        conv(f"i{i}_3x3r", p3r, 1, f"i{i}_relu3r", inputs=[x])
        b3 = conv(f"i{i}_3x3", p3, 3, f"i{i}_relu3", pad=1)
        conv(f"i{i}_5x5r", p5r, 1, f"i{i}_relu5r", inputs=[x])
        b5 = conv(f"i{i}_5x5", p5, 5, f"i{i}_relu5", pad=2)
        add("maxpool", f"i{i}_pool", [x], k=3, stride=1, pad=1)
        bp = conv(f"i{i}_poolproj", pp, 1, f"i{i}_relupp")
        return add("concat", f"i{i}_concat", [b1, b3, b5, bp])

    conv("conv1", 64, 7, "relu1", stride=2, pad=3)
    add("maxpool", "pool1", k=3, stride=2, pad=1)
    add("lrn", "norm1", **LRN)
    conv("conv2r", 64, 1, "relu2r")
    conv("conv2", 192, 3, "relu2", pad=1)
    add("lrn", "norm2", **LRN)
    x = add("maxpool", "pool2", k=3, stride=2, pad=1)
    for i in ("3a", "3b"):
        x = inception(x, i, *INCEPTION[i])
    x = add("maxpool", "pool3", [x], k=3, stride=2, pad=1)
    for i in ("4a", "4b", "4c", "4d", "4e"):
        x = inception(x, i, *INCEPTION[i])
    x = add("maxpool", "pool4", [x], k=3, stride=2, pad=1)
    for i in ("5a", "5b"):
        x = inception(x, i, *INCEPTION[i])
    add("gap", "gap", [x])
    add("fc", "fc", features=1000, relu=False)
    add("softmax", "prob")
    return out


def googlenet_config():
    """A configuration file's contents for the list: VGG-16's selector,
    bucket policy and executables."""
    vgg = json.loads((BENCH / "configs" / "vgg16.json").read_text())
    cfg = {k: copy.deepcopy(vgg[k]) for k in
           ("dtype", "selector", "bucket_policy", "jit", "reference")}
    cfg.update(name="googlenet", network="googlenet", input=[3, 224, 224],
               cpu_scale=CPU_SCALE, layers=googlenet_layers())
    return cfg


def googlenet_spec(trace):
    """GoogLeNet under ``vgg16.offline-b16``'s traffic and metrics, with
    the limit 1e-4 and the reference in blocks of 32."""
    import cell
    spec = cell.load_spec("vgg16.offline-b16", trace)
    spec.workload = "googlenet.offline-b16"
    spec.config = googlenet_config()
    spec.checks = {"logit_rel_err": {"limit": 1e-4}, "block": 32}
    return spec


def test_the_shapes_are_the_programs_and_the_work_is_counted():
    from repro_torch.convnets import googlenet
    net = googlenet(1.0)
    layers = work.layers(googlenet_layers(), (3, 224, 224))
    assert [l.name for l in layers] == net.order[1:]
    for l in layers:
        assert l.out_shape == tuple(net.nodes[l.name].out_shape), l.name
        assert l.inputs == tuple(net.nodes[l.name].inputs) or \
            l.inputs == () and net.nodes[l.name].inputs == ["data"], l.name
    by_name = {l.name: l for l in layers}
    assert [by_name[p].out_shape for p in ("pool1", "pool2", "pool3", "pool4",
                                           "gap")] == \
        [(64, 56, 56), (192, 28, 28), (480, 14, 14), (832, 7, 7),
         (1024, 1, 1)]
    assert sum(l.op == "conv" for l in layers) == 57
    t = work.totals(layers)
    assert (t["direct"], t["least"], t["params"]) == \
        (1_582_671_872, 668_209_152, 6_998_552)


def test_the_reference_draws_the_programs_weights():
    assert_draws_the_programs_weights(googlenet_config(), CPU_SCALE)


@pytest.mark.parametrize("fault", [None, roll_classes],
                         ids=["sound", "roll_classes"])
def test_a_cpu_run_is_correct_unless_broken(fault, monkeypatch):
    """``cell.run`` on the in-memory cell: correct, and not correct with
    the executable that the window drives broken underneath."""
    import cell
    import load
    from repro_torch.core.plan import CompiledNet
    spec = googlenet_spec(False)
    monkeypatch.setattr(cell, "load_spec", lambda w, trace: spec)
    monkeypatch.setattr(load, "sampled", lambda seed, j, every: True)
    if fault is not None:
        call = CompiledNet.__call__
        monkeypatch.setattr(CompiledNet, "__call__",
                            lambda self, x: fault(call(self, x)))
    out = cell.run(spec.workload, 4_000_000_555, 3.0, False,
                   t_start=time.perf_counter(), device="cpu",
                   scale=CPU_SCALE)
    assert out["compared_images"] > 0 and out["failed"] == 0
    c = out["checks"]["logit_rel_err"]
    if fault is None:
        assert out["correct"] is True, out["checks"]
    else:
        assert out["correct"] is False and c["value"] > c["limit"]


def test_a_wrong_producer_fails_at_set_up_by_the_convs_name(monkeypatch):
    """i3a_3x3 fed from the 1x1 branch (64 channels) in place of its
    reduction (96): the run stops before the server is built."""
    import cell
    spec = googlenet_spec(False)
    entry = next(e for e in spec.config["layers"] if e["name"] == "i3a_3x3")
    entry["inputs"] = ["i3a_relu1"]
    monkeypatch.setattr(cell, "load_spec", lambda w, trace: spec)
    says = r"'i3a_3x3'.*\(64, 5, 5\).*\(96, 5, 5\)"  # 33 px: 5 x 5 planes
    with pytest.raises(RuntimeError, match=says):
        cell.run(spec.workload, 1, 1.0, False, t_start=time.perf_counter(),
                 device="cpu", scale=CPU_SCALE)
