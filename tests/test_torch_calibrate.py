"""The port's calibration path (``repro_torch.calibrate``,
``launch/calibrate.py``, the kernels' ``bench.py``) against the
reference's.

Both packages plan the sweep for AlexNet at full width, batches 1 and 8:
the measurement keys, kinds and labels must be identical.  One synthetic
profile (seconds from a hash of each key) loads in both: every cost the
calibrated model serves, its hit accounting and the PBQP selections must
be identical.  The benchmark builders run on the CPU (plain versions in
the port, Pallas interpret mode in the reference) and must agree: the
convolutions and the GEMM within rtol = atol = 1e-4 (f32 sums in other
orders, as in tests/test_torch_kernels.py), the layout transform exactly,
attention within 2e-5 of the largest magnitude
(tests/test_torch_layout_attention.py).
"""
import hashlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import calibrate as r_cal
from repro.convnets import alexnet as r_alexnet
from repro.core import costs as r_costs
from repro.core import primitives as r_prims
from repro.core.scenario import Scenario as RScenario
from repro.core.selection import select_pbqp as r_select
from repro.kernels import (conv_direct as r_direct, conv_im2col as r_im2col,
                           flash_attention as r_fa,
                           layout_transform as r_lt, matmul as r_mm,
                           winograd_gemm as r_wino)
from repro_torch import calibrate as p_cal
from repro_torch.convnets import alexnet as p_alexnet
from repro_torch.core import costs as p_costs
from repro_torch.core import primitives as p_prims
from repro_torch.core.layouts import default_dt_graph
from repro_torch.core.scenario import Scenario as PScenario
from repro_torch.core.selection import select_pbqp as p_select
from repro_torch.kernels import (conv_direct as p_direct,
                                 conv_im2col as p_im2col,
                                 flash_attention as p_fa,
                                 layout_transform as p_lt, matmul as p_mm,
                                 winograd_gemm as p_wino)
from repro_torch.launch import calibrate as p_cli

BATCHES = (1, 8)
#: the kernel packages, reference and port
PACKAGES = {"conv_direct": (r_direct, p_direct),
            "conv_im2col": (r_im2col, p_im2col),
            "winograd_gemm": (r_wino, p_wino), "matmul": (r_mm, p_mm),
            "flash_attention": (r_fa, p_fa),
            "layout_transform": (r_lt, p_lt)}
#: (rtol, atol) of each builder's output, or None for exact equality;
#: attention is held relative to its largest magnitude instead
TOL = {"conv_direct": (1e-4, 1e-4), "conv_im2col": (1e-4, 1e-4),
       "winograd_gemm": (1e-4, 1e-4), "matmul": (1e-4, 1e-4),
       "layout_transform": None, "flash_attention": 2e-5}
#: small scenarios: every builder, no Winograd (K = 5), and none at all
#: (a window larger than the padded input)
SCN_ARGS = [dict(c=8, h=6, w=6, stride=1, k=3, m=8),
            dict(c=3, h=9, w=9, stride=2, k=5, m=4, pad=1),
            dict(c=4, h=2, w=2, stride=1, k=5, m=4, pad=0)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plan(cal, net, **kw):
    scns = cal.scenarios_from_net(net(1.0), batches=BATCHES)
    kw = {"device": "cpu", **kw} if cal is p_cal else kw
    return cal.plan_sweep(scns, kernels=True, **kw)


def _seconds(key: str) -> float:
    return (int(hashlib.sha256(key.encode()).hexdigest()[:8], 16) % 10 ** 6
            + 1) * 1e-9


@pytest.fixture(scope="module")
def plans():
    return {"ref": _plan(r_cal, r_alexnet, exclude_tags=()),
            "port": _plan(p_cal, p_alexnet, exclude_tags=())}


@pytest.fixture(scope="module")
def payload(plans):
    """One synthetic profile over every planned key."""
    return {"schema": 1, "device": "cpu:cpu:n1", "registry": "synthetic",
            "created": "", "reps": 3, "min_time": 5e-3,
            "entries": {it.key: _seconds(it.key) for it in plans["ref"]}}


# ----------------------------------------------------------------------
# benchmark builders
# ----------------------------------------------------------------------
def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_benchmark_entries_agree(pkg):
    ref, port = PACKAGES[pkg]
    built = 0
    for args in SCN_ARGS:
        rb = ref.benchmark_entry(RScenario(**args))
        pb = port.benchmark_entry(PScenario(**args), device="cpu")
        assert (rb is None) == (pb is None), args
        if rb is None:
            continue
        (rfn, rargs), (pfn, pargs) = rb(), pb()
        assert [tuple(a.shape) for a in rargs] == \
            [tuple(a.shape) for a in pargs]
        for ra, pa in zip(rargs, pargs):  # the same draws
            np.testing.assert_array_equal(_np(pa), _np(ra))
        want, got = _np(rfn(*rargs)), _np(pfn(*pargs))
        assert got.shape == want.shape
        tol = TOL[pkg]
        if tol is None:
            np.testing.assert_array_equal(got, want)
        elif isinstance(tol, float):
            assert np.abs(got - want).max() <= tol * np.abs(want).max()
        else:
            np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1])
        built += 1
    assert built >= 1


# ----------------------------------------------------------------------
# the sweep plan
# ----------------------------------------------------------------------
def _triples(items):
    return [(it.kind, it.key, it.label) for it in items]


def test_plan_is_the_references_without_exclusions(plans):
    assert _triples(plans["port"]) == _triples(plans["ref"])
    assert len(plans["port"]) == 2024
    kinds = {k: sum(1 for it in plans["port"] if it.kind == k)
             for k in ("prim", "fuse", "dt", "kernel")}
    assert kinds == {"prim": 518, "fuse": 1380, "dt": 70, "kernel": 56}


def test_plan_under_each_default_exclusion():
    ref, port = _plan(r_cal, r_alexnet), _plan(p_cal, p_alexnet)
    assert _triples(port) == _triples(ref)
    assert len(port) == 1960
    assert not any(it.label.startswith("pallas:") for it in port)


@pytest.mark.parametrize("grid", sorted(r_cal.GRIDS))
def test_scenario_grid_equal(grid):
    for batches in ((1,), (1, 4)):
        want = [s.key() for s in r_cal.scenario_grid(grid, batches=batches)]
        got = [s.key() for s in p_cal.scenario_grid(grid, batches=batches)]
        assert got == want


def test_run_sweep_resumes_and_saves(tmp_path):
    scn = PScenario(c=8, h=16, w=16, stride=1, k=3, m=16)
    items = p_cal.plan_sweep([scn], families=["direct"], dt=False,
                             device="cpu")
    prof = p_cal.HardwareProfile.new(device="cpu:cpu:n1")
    path, calls = tmp_path / "hw.json", []

    def stub(item):
        calls.append(item.key)
        return 1e-3

    r1 = p_cal.run_sweep(prof, items, save_path=path, save_every=2,
                         max_entries=3, measure=stub)
    assert r1 == {"measured": 3, "skipped": 0, "remaining": len(items) - 3}
    assert len(p_cal.HardwareProfile.load(path)) == 3
    r2 = p_cal.run_sweep(prof, items, save_path=path, measure=stub)
    assert r2["skipped"] == 3 and r2["remaining"] == 0
    assert len(calls) == len(set(calls)) == len(items)


# ----------------------------------------------------------------------
# the profile
# ----------------------------------------------------------------------
def test_profile_payload_loads_in_both_packages(tmp_path, payload):
    a = tmp_path / "ref.json"
    b = tmp_path / "port.json"
    r_cal.HardwareProfile.from_payload(payload).save(a)
    p_cal.HardwareProfile.from_payload(payload).save(b)
    assert json.loads(a.read_text()) == json.loads(b.read_text())
    pa, rb = p_cal.HardwareProfile.load(a), r_cal.HardwareProfile.load(b)
    assert pa.entries == rb.entries == payload["entries"]
    assert pa.content_hash() == rb.content_hash()
    assert p_cal.PROFILE_SCHEMA == r_cal.PROFILE_SCHEMA


def test_profile_schema_and_device_are_checked():
    bad = {"schema": 99, "device": "cpu:cpu:n1", "registry": "x",
           "entries": {}}
    with pytest.raises(ValueError, match="schema"):
        p_cal.HardwareProfile.from_payload(bad)
    prof = p_cal.HardwareProfile.new(device="cuda:NVIDIA_H100:sm90:n1")
    with pytest.raises(ValueError, match="measured on"):
        p_cal.CalibratedCostModel(prof, device="cpu")
    cm = p_cal.CalibratedCostModel(prof, check_device=False)
    assert cm.exclude_tags == ()  # measured on an sm_90 card
    cpu = p_cal.HardwareProfile.new(device=p_cal.device_fingerprint("cpu"))
    assert cpu.device == "cpu:cpu:n1"
    assert p_cal.CalibratedCostModel(cpu, device="cpu").exclude_tags == \
        ("kernel",)
    assert cpu.registry == p_cal.registry_hash() != r_cal.registry_hash()


def test_fingerprint_and_entry_points_need_a_card_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_cal.device_fingerprint()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_cli.main(["--out", str(tmp_path / "hw.json"), "--grid", "tiny",
                    "--dry-run"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_mm.benchmark_entry(PScenario(c=8, h=6, w=6, stride=1, k=3,
                                       m=8))()


# ----------------------------------------------------------------------
# calibrated costs and selection on one synthetic profile
# ----------------------------------------------------------------------
def _models(payload, exclude):
    kw = {} if exclude == "default" else {"exclude_tags": ()}
    return (r_cal.CalibratedCostModel(
                r_cal.HardwareProfile.from_payload(payload),
                check_device=False, **kw),
            p_cal.CalibratedCostModel(
                p_cal.HardwareProfile.from_payload(payload),
                check_device=False, **kw))


@pytest.mark.parametrize("exclude", ["default", "none"])
def test_calibrated_costs_equal(payload, exclude):
    rm, pm = _models(payload, exclude)
    rprims = {p.name: p for p in r_prims.registry()}
    pprims = {p.name: p for p in p_prims.registry()}
    assert rprims.keys() == pprims.keys()
    layouts = ("CHW", "HWC", "HCW", "HWC8", "CWH")
    n = 0
    for b in BATCHES:
        for rnode, pnode in zip(r_alexnet(1.0).with_batch(b).conv_nodes(),
                                p_alexnet(1.0).with_batch(b).conv_nodes()):
            rs, ps = rnode.scn, pnode.scn
            assert rs.key() == ps.key()
            for name, rp in rprims.items():
                pp = pprims[name]
                assert pm.primitive_cost(pp, ps) == \
                    rm.primitive_cost(rp, rs), name
                for lay in layouts:
                    assert pm.fused_in_cost(pp, ps, lay) == \
                        rm.fused_in_cost(rp, rs, lay), (name, lay)
                    assert pm.fused_out_cost(pp, ps, lay) == \
                        rm.fused_out_cost(rp, rs, lay), (name, lay)
                    n += 1
            for src, dst in default_dt_graph().direct_edges:
                for shape in (rs.in_shape_chw, rs.out_shape_chw):
                    assert pm.transform_cost(src, dst, shape, "float32") == \
                        rm.transform_cost(src, dst, shape, "float32")
    assert n > 0
    assert (pm.table_hits, pm.fallback_hits) == (rm.table_hits,
                                                 rm.fallback_hits)
    assert pm.table_hits > 0 and pm.fallback_hits > 0


@pytest.mark.parametrize("batch", BATCHES)
def test_calibrated_selection_equal(payload, batch):
    rm, pm = _models(payload, "default")
    rsel = r_select(r_alexnet(1.0).with_batch(batch), rm)
    psel = p_select(p_alexnet(1.0).with_batch(batch), pm)
    pick = lambda sel: {n: (c.primitive and c.primitive.name, c.l_in,
                            c.l_out) for n, c in sel.choices.items()}
    assert pick(psel) == pick(rsel)
    assert psel.predicted_cost == rsel.predicted_cost
    assert psel.conversions == rsel.conversions
    assert (pm.table_hits, pm.fallback_hits) == (rm.table_hits,
                                                 rm.fallback_hits)


def test_analytic_fallback_default_is_the_references(payload):
    rm, pm = _models(payload, "default")
    assert pm.fallback.version() != "" and \
        isinstance(pm.fallback, p_costs.AnalyticCostModel)
    assert pm.fallback.spec.name == rm.fallback.spec.name == \
        r_costs.AnalyticCostModel().spec.name


# ----------------------------------------------------------------------
# the CLI on the CPU
# ----------------------------------------------------------------------
def _cli(tmp_path, capsys, *extra):
    rc = p_cli.main(["--out", str(tmp_path / "hw.json"), "--device", "cpu",
                     "--grid", "tiny", "--reps", "1", "--min-time", "1e-4",
                     *extra])
    assert rc == 0
    return capsys.readouterr().out


def test_cli_plans_measures_and_resumes(tmp_path, capsys):
    out = _cli(tmp_path, capsys, "--dry-run")
    assert "384 measurements" in out and "cpu:cpu:n1" in out
    assert not (tmp_path / "hw.json").exists()
    out = _cli(tmp_path, capsys)
    assert "measured 384, skipped 0 covered, 0 remaining" in out
    prof = p_cal.HardwareProfile.load(tmp_path / "hw.json")
    assert len(prof) == 384 and prof.device == "cpu:cpu:n1"
    assert all(v > 0 for v in prof.entries.values())
    out = _cli(tmp_path, capsys)
    assert "measured 0, skipped 384 covered, 0 remaining" in out


def test_cli_on_the_cpu_excludes_the_kernels_as_the_reference(tmp_path,
                                                              capsys):
    out = _cli(tmp_path, capsys, "--dry-run", "--kernels", "on")
    # the kernel microbenchmarks join; the kernel primitives stay out
    assert "'kernel': 6" in out and "pallas" not in out
    scns = p_cal.scenario_grid("tiny")
    items = p_cal.plan_sweep(scns, kernels=True, device="cpu")
    ref = r_cal.plan_sweep(r_cal.scenario_grid("tiny"), kernels=True)
    assert _triples(items) == _triples(ref)
    assert not any(it.key.split("::")[1].startswith("pallas_")
                   for it in items if it.kind in ("prim", "fuse"))


def test_measure_cache_packs_each_bucket_once():
    """The sweep's shared cache changes no input: the same draws and the
    same packed weights as an uncached measurement, packed once per
    (primitive, bucket) across batches and fused layouts."""
    import dataclasses
    prim = next(p for p in p_prims.registry()
                if p.name == "wino2d_f2x3_chw")
    calls = []

    def prepare(scn, w, b):
        calls.append(scn.key())
        return prim.prepare(scn, w, b)

    counted = dataclasses.replace(prim, prepare=prepare)
    scn = PScenario(c=8, h=10, w=10, stride=1, k=3, m=16)
    cache = p_costs.MeasureCache()
    for s, lay in ((scn, "CHW"), (scn, "HWC"), (scn.with_(n=8), "CHW")):
        x, packed = p_costs._synth(counted, s, lay, torch.device("cpu"),
                                   cache)
        x0, packed0 = p_costs._synth(prim, s, lay, torch.device("cpu"),
                                     None)
        assert torch.equal(x, x0)
        assert packed.keys() == packed0.keys()
        assert all(torch.equal(packed[k], packed0[k]) for k in packed)
    assert calls == [scn.key()]
