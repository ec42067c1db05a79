"""The port's drift detection (``repro_torch.obs.drift``) against the
reference's (``repro.obs.drift``).

* ``plan_predictions`` itemizes the same objective, term by term, for
  the same net under one synthetic profile loaded in both packages (as
  tests/test_torch_calibrate.py builds one: seconds from a hash of each
  key);
* ``DriftDetector``, fed identical timing dicts in both packages, gives
  the same ``report()``, ``flagged()`` and ``recommendation()``, and
  writes the same entries into the profile;
* ``InstrumentedNet`` on the CPU returns the eager walk's outputs bit
  for bit and the reference's within 1e-4 of the largest magnitude,
  with a timing for every node and every converted edge;
* ``recalibration_loop`` converges, round for round as the reference's,
  on a patched clock.

No test gates on a real timing: the timings are given, or come from a
clock that advances by one fixed step per reading.
"""
import hashlib
import types

import numpy as np
import pytest
import torch

from repro import calibrate as r_cal
from repro.convnets import alexnet as r_alexnet
from repro.core import primitives as r_prims
from repro.core.costs import AnalyticCostModel as RAnalytic
from repro.core.plan import compile_plan as r_compile
from repro.core.selection import select_fixed as r_fixed
from repro.core.selection import select_pbqp as r_select
from repro.obs import drift as r_drift
from repro.serving.towers import conv_stack as r_conv_stack
from repro_torch import calibrate as p_cal
from repro_torch import obs as p_obs
from repro_torch.convnets import alexnet as p_alexnet
from repro_torch.core import primitives as p_prims
from repro_torch.core.costs import AnalyticCostModel as PAnalytic
from repro_torch.core.plan import compile_plan as p_compile
from repro_torch.core.selection import select_fixed as p_fixed
from repro_torch.core.selection import select_pbqp as p_select
from repro_torch.obs import drift as p_drift
from repro_torch.serving.towers import conv_stack as p_conv_stack

#: the reference's bounded primitive pool for the recalibration loop
ALLOWED = ("direct_lax_chw_chw_oihw", "direct_lax_hwc_hwc_hwio",
           "wino2d_f2x3_chw")
#: nets (reference builder, port builder, batch)
NETS = {"alexnet_b1": (lambda: r_alexnet(1.0), lambda: p_alexnet(1.0), 1),
        "alexnet_b8": (lambda: r_alexnet(1.0), lambda: p_alexnet(1.0), 8),
        "conv_stack": (lambda: r_conv_stack((3, 16, 16), depth=3, width=8),
                       lambda: p_conv_stack((3, 16, 16), depth=3, width=8),
                       1)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seconds(key: str) -> float:
    return (int(hashlib.sha256(key.encode()).hexdigest()[:8], 16) % 10 ** 6
            + 1) * 1e-9


def _factor(key: str) -> float:
    """A drift factor per entry, from its name: some inside a 2x
    threshold, some outside on either side."""
    return (0.2, 0.7, 1.0, 1.6, 3.5, 9.0)[
        int(hashlib.sha256(key.encode()).hexdigest()[:4], 16) % 6]


def _payload(net, batch):
    """One synthetic profile over every key the port plans for ``net``."""
    scns = p_cal.scenarios_from_net(net, batches=(batch,))
    items = p_cal.plan_sweep(scns, exclude_tags=(), device="cpu")
    return {"schema": 1, "device": "cpu:cpu:n1", "registry": "synthetic",
            "created": "", "reps": 3, "min_time": 5e-3,
            "entries": {it.key: _seconds(it.key) for it in items}}


def _pick(sel):
    return {n: (c.primitive and c.primitive.name, c.l_in, c.l_out)
            for n, c in sel.choices.items()}


@pytest.fixture(scope="module", params=sorted(NETS))
def solved(request):
    """Both packages' calibrated models on one synthetic profile and
    their (identical) selections."""
    r_net, p_net, batch = (f() if callable(f) else f
                           for f in NETS[request.param])
    r_net, p_net = r_net.with_batch(batch), p_net.with_batch(batch)
    payload = _payload(p_net, batch)
    rm = r_cal.CalibratedCostModel(
        r_cal.HardwareProfile.from_payload(payload), check_device=False)
    pm = p_cal.CalibratedCostModel(
        p_cal.HardwareProfile.from_payload(payload), check_device=False)
    rsel, psel = r_select(r_net, rm), p_select(p_net, pm)
    assert _pick(psel) == _pick(rsel)
    assert psel.conversions == rsel.conversions
    return payload, (rm, rsel), (pm, psel)


# ----------------------------------------------------------------------
# predictions and the detector
# ----------------------------------------------------------------------
def test_plan_predictions_equal_the_references(solved):
    _, (rm, rsel), (pm, psel) = solved
    want = r_drift.plan_predictions(rsel, rm)
    got = p_drift.plan_predictions(psel, pm)
    assert got == want
    total = sum(got["node"].values()) + sum(got["edge"].values())
    assert total == pytest.approx(psel.predicted_cost, rel=1e-9)


def _timings(pred, run):
    """Observed seconds per term: the prediction times a factor of the
    term's name and the run."""
    return {"node": {nid: s * _factor(f"{nid}/{run}")
                     for nid, s in pred["node"].items()},
            "edge": {e: s * _factor(f"{e}/{run}")
                     for e, s in pred["edge"].items()},
            "unmodeled_s": 1e-4 * (run + 1)}


def test_detector_equals_the_references(solved):
    payload, (rm, rsel), (pm, psel) = solved
    rdet = r_drift.DriftDetector(rm, threshold=2.0)
    pdet = p_drift.DriftDetector(pm, threshold=2.0)
    pred = p_drift.plan_predictions(psel, pm)
    for run in range(3):
        tm = _timings(pred, run)
        rdet.observe(rsel, tm)
        pdet.observe(psel, tm)
    assert pdet.report() == rdet.report()
    assert [(e.kind, e.nid, e.profile_key, e.ewma_observed_s)
            for e in pdet.flagged()] == \
        [(e.kind, e.nid, e.profile_key, e.ewma_observed_s)
         for e in rdet.flagged()]
    assert pdet.flagged(), "the factors put some entry past 2x"
    assert pdet.recommendation() == rdet.recommendation()
    rprof = r_cal.HardwareProfile.from_payload(payload)
    pprof = p_cal.HardwareProfile.from_payload(payload)
    h0 = pprof.content_hash()
    assert h0 == rprof.content_hash()
    assert pdet.recalibrate(pprof) == rdet.recalibrate(rprof)
    assert pprof.entries == rprof.entries
    assert pprof.content_hash() == rprof.content_hash() != h0


def test_nothing_flagged_writes_nothing(solved):
    payload, _, (pm, psel) = solved
    det = p_drift.DriftDetector(pm, threshold=2.0)
    pred = p_drift.plan_predictions(psel, pm)
    det.observe(psel, {"node": dict(pred["node"]),
                       "edge": dict(pred["edge"]), "unmodeled_s": 0.0})
    assert det.flagged() == [] and det.plan_within_threshold()
    prof = p_cal.HardwareProfile.from_payload(payload)
    h0 = prof.content_hash()
    assert det.recalibrate(prof) == []
    assert prof.content_hash() == h0


def test_restricted_model_versions_and_prices():
    payload = _payload(p_conv_stack((3, 16, 16), depth=3, width=8), 1)
    prof = p_cal.HardwareProfile.from_payload(payload)
    cm = p_cal.CalibratedCostModel(prof, check_device=False)
    r = p_drift.RestrictedCostModel(cm, ALLOWED)
    assert r.version().endswith("+allow=" + ",".join(sorted(ALLOWED)))
    net = p_conv_stack((3, 16, 16), depth=3, width=8)
    scn = net.conv_nodes()[0].scn
    for p in p_prims.registry():
        want = cm.primitive_cost(p, scn) if p.name in ALLOWED \
            else float("inf")
        assert r.primitive_cost(p, scn) == want


def test_obs_exports_drift_lazily():
    assert p_obs.InstrumentedNet is p_drift.InstrumentedNet
    assert p_obs.drift is p_drift
    with pytest.raises(AttributeError):
        p_obs.no_such_name


# ----------------------------------------------------------------------
# instrumented execution
# ----------------------------------------------------------------------
def _mixed(fixed, prims, net, cm):
    """A plan with a layout conversion and a kernel primitive: conv0 in
    HWC, the rest CHW, conv1 on the im2col GEMM entry."""
    by = {p.name: p for p in prims.registry()}
    convs = [n.id for n in net.conv_nodes()]
    pick = {nid: by["direct_lax_chw_chw_oihw"] for nid in convs}
    pick[convs[0]] = by["direct_lax_hwc_hwc_hwio"]
    pick[convs[1]] = by["pallas_im2col_chw"]
    return fixed(net, cm, pick, "mixed")


@pytest.mark.parametrize("batch", [1, 2])
def test_instrumented_net_is_the_eager_walk(batch):
    shape = (3, 16, 16)
    r_net = r_conv_stack(shape, depth=3, width=8).with_batch(batch)
    p_net = p_conv_stack(shape, depth=3, width=8).with_batch(batch)
    rsel = _mixed(r_fixed, r_prims, r_net, RAnalytic())
    psel = _mixed(p_fixed, p_prims, p_net, PAnalytic())
    assert _pick(psel) == _pick(rsel) and psel.conversions
    params = r_net.init_params(0)
    x = np.random.default_rng(batch).normal(
        size=shape if batch == 1 else (batch, *shape)).astype(np.float32)

    cnet = p_compile(psel, params, batch=batch, jit=False, device="cpu")
    outs, tm = p_drift.InstrumentedNet(cnet)(x)
    eager = cnet(x)
    assert outs.keys() == eager.keys()
    for k in eager:
        assert torch.equal(outs[k], eager[k]), k
    assert set(tm["node"]) == {n for n in p_net.order
                               if p_net.nodes[n].kind != "input"}
    assert set(tm["edge"]) == set(psel.conversions)
    assert all(t > 0 for t in tm["node"].values())
    assert tm["unmodeled_s"] > 0

    rout, _ = r_drift.InstrumentedNet(
        r_compile(rsel, params, batch=batch))(x)
    for k, v in rout.items():
        want = np.asarray(v, np.float32)
        err = float(np.abs(outs[k].numpy() - want).max())
        assert err <= 1e-4 * float(np.abs(want).max()), (k, err)


def test_instrumented_net_returns_inner_outputs_in_chw():
    """A plan compiled with inner outputs (every conv, as chip_smoke
    compares plans) returns each in logical CHW, as the eager walk."""
    net = p_conv_stack((3, 16, 16), depth=3, width=8)
    psel = _mixed(p_fixed, p_prims, net, PAnalytic())
    taps = [n.id for n in net.conv_nodes()]
    cnet = p_compile(psel, net.init_params(0), jit=False, device="cpu",
                     outputs=taps)
    x = np.random.default_rng(3).normal(size=(3, 16, 16)).astype(
        np.float32)
    outs, _ = p_drift.InstrumentedNet(cnet, warmup=False)(x)
    eager = cnet(x)
    assert list(outs) == taps
    for k in taps:
        assert torch.equal(outs[k], eager[k])


# ----------------------------------------------------------------------
# the recalibration loop on a patched clock
# ----------------------------------------------------------------------
def _stepping_clock(step=2.0 ** -10):
    """A clock that advances by ``step`` at every reading: each timed
    step observes exactly ``step`` seconds (a power of two, so the
    differences are exact)."""
    t = [0.0]

    def clock():
        t[0] += step
        return t[0]
    return clock


def test_recalibration_loop_converges_as_the_reference(monkeypatch):
    shape = (3, 16, 16)
    monkeypatch.setattr(p_drift, "_clock", _stepping_clock())
    monkeypatch.setattr(r_drift, "time",
                        types.SimpleNamespace(perf_counter=_stepping_clock()))
    r_net = r_conv_stack(shape, depth=2, width=8)
    p_net = p_conv_stack(shape, depth=2, width=8)
    params = r_net.init_params(0)
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    rprof = r_cal.HardwareProfile.new()
    pprof = p_cal.HardwareProfile.new(device="cpu:cpu:n1")

    want = r_drift.recalibration_loop(r_net, params, x, rprof,
                                      allowed=ALLOWED, runs=2)
    got = p_drift.recalibration_loop(p_net, params, x, pprof,
                                     allowed=ALLOWED, runs=2,
                                     device="cpu")
    assert got["converged"] and want["converged"]
    assert got["detector"].plan_within_threshold()
    assert 1 < len(got["rounds"]) <= 8
    assert got["rounds"] == want["rounds"]
    assert pprof.entries == rprof.entries and pprof.entries
    assert got["detector"].report() == want["detector"].report()

    # converged: a further loop on the same profile writes nothing
    h = pprof.content_hash()
    again = p_drift.recalibration_loop(p_net, params, x, pprof,
                                       allowed=ALLOWED, runs=2,
                                       device="cpu")
    assert again["converged"] and len(again["rounds"]) == 1
    assert pprof.content_hash() == h


def test_recalibration_loop_needs_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    net = p_conv_stack((3, 16, 16), depth=2, width=8)
    prof = p_cal.HardwareProfile.new(device="cpu:cpu:n1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_drift.recalibration_loop(net, net.init_params(0),
                                   np.zeros((3, 16, 16), np.float32), prof)
