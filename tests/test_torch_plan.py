"""Whole-net outputs of the port's ``compile_plan`` against the
reference's.

The same numpy weights (``Net.init_params``, handed to the port through
``params_from_numpy``) and the same numpy inputs go through both
packages' executables on small AlexNet and GoogLeNet: the PBQP plan with
the kernel primitives priced, a plan that pins every kernel primitive
onto the convs it supports, and the SUM2D plan; materialized and fused;
at batch 1 and 4.  The reference's Pallas kernels run in interpret mode,
the port's kernel primitives through their plain versions.

Each net also returns its pre-softmax logits (an identity op on the
softmax's input).  A softmax over 1000 classes is about 1e-3 per class,
so the probabilities alone would hide a small systematic error; the
logits are held within 1e-3 of their largest magnitude (both packages
sum in f32, in different orders), the probabilities at 2e-3 (rtol =
atol), the quickstart's own tolerance for PBQP against SUM2D.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.convnets import NETWORKS as R_NETWORKS
from repro.core import costs as RC
from repro.core import graph as RG
from repro.core import plan as RPL
from repro.core import primitives as RP
from repro.core import selection as RS
from repro_torch.convnets import NETWORKS as T_NETWORKS
from repro_torch.core import costs as TC
from repro_torch.core import graph as TG
from repro_torch.core import plan as TPL
from repro_torch.core import primitives as TP
from repro_torch.core import selection as TS

TOL = dict(rtol=2e-3, atol=2e-3)
#: every output against the reference, as a share of its largest magnitude
REL_TOL = 1e-3
NETS = {"alexnet": 0.3, "googlenet": 0.2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    PyTorch's default of one thread per core would oversubscribe the
    machine under the timing-sensitive tests of the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models():
    return (RC.AnalyticCostModel(RC.TPU_V5E_SPEC, include_tpu_only=True),
            TC.AnalyticCostModel(
                TC.HardwareSpec(**dataclasses.asdict(RC.TPU_V5E_SPEC)),
                include_kernels=True))


def _with_logits(net, graph):
    """``net`` with the softmax's input as a second output, ``logits``."""
    soft = next(n for n in net.order if net.nodes[n].kind == "op"
                and net.nodes[n].op.name == "softmax")
    net.op("logits", [net.nodes[soft].inputs[0]], graph.identity("logits"))
    return net


def _pins(net, registry):
    """Every conv onto a kernel primitive: the 1x1 GEMM where K = 1,
    otherwise the direct, im2col and Winograd kernels in turn."""
    reg = {p.name: p for p in registry()}
    cycle = ["pallas_direct_hwc", "pallas_wino_f4x3_chw",
             "pallas_im2col_chw", "pallas_wino_f2x3_chw"]
    pick = {}
    for i, node in enumerate(net.conv_nodes()):
        names = ["pallas_pw_gemm_chw"] if node.scn.k == 1 else \
            cycle[i % 4:] + cycle[:i % 4]
        pick[node.id] = next(reg[n] for n in names
                             if reg[n].supports(node.scn))
    return pick


def _select(S, registry, net, cost, plan, fuse):
    if plan == "pbqp":
        return S.select_pbqp(net, cost, fuse=fuse)
    if plan == "kernels":
        return S.select_fixed(net, cost, _pins(net, registry), "kernels",
                              fuse=fuse)
    return S.select_sum2d(net, cost)


#: (net, plan, fuse, batch).  AlexNet takes every combination; GoogLeNet,
#: whose reference plans compile slowest (Pallas interpret mode under
#: jit), takes the fused PBQP plan (its concat fan-outs), the pinned
#: kernels at batch 4 (the 1x1 GEMM's only net) and SUM2D.
CASES = [("alexnet", plan, fuse, batch)
         for plan, fuse in [("pbqp", False), ("pbqp", True),
                            ("kernels", False), ("kernels", True),
                            ("sum2d", False)]
         for batch in (1, 4)] + [
    ("googlenet", "pbqp", True, 1), ("googlenet", "kernels", False, 4),
    ("googlenet", "sum2d", False, 1)]


@pytest.mark.parametrize("name,plan,fuse,batch", CASES)
def test_outputs_agree_with_the_reference(name, plan, fuse, batch):
    rnet = _with_logits(R_NETWORKS[name](NETS[name]), RG)
    tnet = _with_logits(T_NETWORKS[name](NETS[name]), TG)
    rcost, tcost = _models()
    rsel = _select(RS, RP.registry, rnet, rcost, plan, fuse)
    tsel = _select(TS, TP.registry, tnet, tcost, plan, fuse)
    assert {k: c.primitive.name for k, c in tsel.choices.items()
            if c.primitive} == \
        {k: c.primitive.name for k, c in rsel.choices.items() if c.primitive}
    assert (tsel.conversions, tsel.fusions) == \
        (rsel.conversions, rsel.fusions)

    raw = rnet.init_params(seed=0)
    rng = np.random.default_rng(batch)
    shape = rnet.nodes["data"].out_shape
    x = rng.normal(size=(batch,) + shape if batch > 1 else shape).astype(
        np.float32)
    want = RPL.compile_plan(rsel, raw, batch=batch)(x)
    tnet_params = TPL.params_from_numpy(raw, device="cpu")
    cnet = TPL.compile_plan(tsel, tnet_params, batch=batch, device="cpu")
    got = cnet(x)
    assert cnet.fused_edges == len(rsel.fusions)
    assert got.keys() == want.keys() == {"prob", "logits"}
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= REL_TOL * np.abs(w).max(), k
    np.testing.assert_allclose(got["prob"].numpy(), np.asarray(want["prob"]),
                               **TOL)


def test_outputs_return_inner_nodes_in_logical_chw():
    """``compile_plan(outputs=...)`` returns every conv (one of them
    emitting its consumer's layout through a fused epilogue), the logits
    and the probabilities; the plan pinned onto the kernels agrees with
    SUM2D at each."""
    net = T_NETWORKS["googlenet"](NETS["googlenet"])
    _, tcost = _models()
    raw = net.init_params(seed=0)
    x = np.random.default_rng(5).normal(
        size=net.nodes["data"].out_shape).astype(np.float32)
    sel = _select(TS, TP.registry, net, tcost, "kernels", True)
    assert "out" in sel.fusions.values()
    names = [n.id for n in net.conv_nodes()] + \
        [net.nodes["prob"].inputs[0], "prob"]
    got = TPL.compile_plan(sel, raw, device="cpu", outputs=names)(x)
    want = TPL.compile_plan(TS.select_sum2d(net, tcost), raw, device="cpu",
                            outputs=names)(x)
    sinks = TPL.compile_plan(sel, raw, device="cpu")(x)
    assert list(got) == names and list(sinks) == ["prob"]
    np.testing.assert_array_equal(got["prob"].numpy(), sinks["prob"].numpy())
    for k in names:
        g, w = got[k].numpy(), want[k].numpy()
        assert g.shape == w.shape == net.nodes[k].out_shape
        assert np.abs(g - w).max() <= REL_TOL * np.abs(w).max(), k
    with pytest.raises(ValueError, match="not computed nodes"):
        TPL.compile_plan(sel, raw, device="cpu", outputs=["data"])


def test_params_from_numpy_keeps_every_value():
    net = T_NETWORKS["alexnet"](0.3)
    raw = net.init_params(seed=3)
    ported = TPL.params_from_numpy(raw, device="cpu")
    assert ported.keys() == raw.keys()
    for nid, p in raw.items():
        for k, v in p.items():
            np.testing.assert_array_equal(ported[nid][k].numpy(), v)


def test_init_params_and_fingerprints_match_the_reference():
    for name in ("alexnet", "googlenet", "vgg-a"):
        rnet, tnet = R_NETWORKS[name](0.3), T_NETWORKS[name](0.3)
        assert tnet.fingerprint() == rnet.fingerprint()
        a, b = rnet.init_params(seed=7), tnet.init_params(seed=7)
        assert a.keys() == b.keys()
        for nid in a:
            for k in a[nid]:
                np.testing.assert_array_equal(a[nid][k], b[nid][k])


def test_measure_and_compile_count():
    net = T_NETWORKS["alexnet"](0.3)
    _, tcost = _models()
    before = TPL.compile_count()
    cnet = TPL.compile_plan(TS.select_pbqp(net, tcost), net.init_params(0),
                            device="cpu")
    assert TPL.compile_count() == before + 1
    x = np.zeros(net.nodes["data"].out_shape, np.float32)
    m = TPL.measure(cnet, x, reps=2)
    assert m["min_s"] > 0 and m["mean_s"] >= m["min_s"]
