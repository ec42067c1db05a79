"""The port's reliability layer against the reference's, on the CPU.

``errors``, ``faults``, ``fallback`` and the package ``__init__`` are
byte-for-byte copies (``test_torch_imports.py``); ``quarantine``'s
breaker is the reference's plain Python and its attribution walk
(``diagnose_nonfinite``) runs the port's makers on torch tensors.  So
the tests here hold the two packages to the same behaviour: the same
fault plan, replayed against the reference's ``PlanServer`` and the
port's (``device="cpu"``), must give the same ladder rungs, retries,
quarantines and re-solved selections, the same answers (within
``REL_TOL`` of the reference's largest magnitude: f32 sums in other
orders), and ``diagnose_nonfinite`` must blame the same primitive.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import costs as RC
from repro.core import plan as RPL
from repro.core import selection as RS
from repro.reliability import FallbackLadder as RLadder
from repro.reliability import FaultInjector as RInjector
from repro.reliability import diagnose_nonfinite as r_diagnose
from repro.reliability import parse_fault_plan as r_parse
from repro.reliability import reference_selection as r_reference
from repro.serving import BucketPolicy as RPolicy
from repro.serving import PlanServer as RServer
from repro.serving import conv_stack as r_stack
from repro.serving import conv_tower as r_tower
from repro_torch.core import costs as TC
from repro_torch.core import plan as TPL
from repro_torch.core import selection as TS
from repro_torch.reliability import FallbackLadder as TLadder
from repro_torch.reliability import FaultInjector as TInjector
from repro_torch.reliability import diagnose_nonfinite as t_diagnose
from repro_torch.reliability import parse_fault_plan as t_parse
from repro_torch.reliability import reference_selection as t_reference
from repro_torch.serving import BucketPolicy as TPolicy
from repro_torch.serving import PlanServer as TServer
from repro_torch.serving import conv_stack as t_stack
from repro_torch.serving import conv_tower as t_tower

REL_TOL = 1e-4
COUNTERS = ("requests", "plan_mem_hits", "plan_disk_hits", "plan_misses",
            "exec_hits", "exec_misses", "batch_calls", "coalesced",
            "solves", "warm_solves", "compiles", "plan_cache_corrupt",
            "ladder_exact", "ladder_anytime", "ladder_greedy",
            "ladder_reference", "compile_retries", "compile_fallbacks",
            "kernel_failures", "quarantines")
POLICY = dict(min_hw=8, max_hw=64, max_n=4)
NETS = {"tower": (r_tower, t_tower, dict(depth=2, width=4)),
        "stack64": (r_stack, t_stack, dict(depth=2, width=64))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _costs(kernels):
    if kernels:
        return (RC.AnalyticCostModel(RC.TPU_V5E_SPEC, include_tpu_only=True),
                TC.AnalyticCostModel(
                    TC.HardwareSpec(**dataclasses.asdict(RC.TPU_V5E_SPEC)),
                    include_kernels=True))
    return RC.AnalyticCostModel(), TC.AnalyticCostModel()


def servers(plan="", net="tower", kernels=False, seed=0, **kw):
    """The two servers, each with its own injector on the same plan."""
    rb, tb, bkw = NETS[net]
    rc, tc = _costs(kernels)
    kw.setdefault("compile_backoff_s", 0.001)
    ref = RServer(lambda s: rb(s, **bkw), rc, policy=RPolicy(**POLICY),
                  fault_injector=RInjector(r_parse(plan), seed=seed)
                  if plan else None, **kw)
    port = TServer(lambda s: tb(s, **bkw), tc, policy=TPolicy(**POLICY),
                   fault_injector=TInjector(t_parse(plan), seed=seed)
                   if plan else None, device="cpu", **kw)
    return ref, port


def _img(seed, shape=(3, 16, 16)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _prims(sel):
    return sorted({c.primitive.name for c in sel.choices.values()
                   if c.primitive is not None})


def _plan(sel):
    return (sorted((nid, c.primitive.name if c.primitive else None, c.l_in,
                    c.l_out) for nid, c in sel.choices.items()),
            sorted(sel.conversions.items()), sel.strategy)


def _agree(got, want):
    assert got.keys() == want.keys()
    for nid in want:
        a, b = np.asarray(got[nid]), np.asarray(want[nid])
        assert a.shape == b.shape and np.isfinite(a).all()
        assert float(np.abs(a - b).max()) <= \
            REL_TOL * max(float(np.abs(b).max()), 1e-30), nid


def _run(srv, requests):
    """Answers of a short stream, or the failure's type name."""
    outs = []
    for kind, x in requests:
        try:
            outs.append(srv.infer(x) if kind == "infer" else
                        srv.infer_batch(x)[0])
        except Exception as exc:  # the reference's typed failure
            outs.append(type(exc).__name__)
    return outs


def _state(srv):
    s = srv.stats()
    return ({k: s[k] for k in COUNTERS}, s["quarantined"],
            {k: _plan(v) for k, v in srv._plans.items()})


# (fault plan, net, kernels priced, server options)
FAULT_PLANS = {
    "solve_raise": ("solve:raise@0+1", "tower", False, {}),
    "solve_budget": ("solve:budget@0+2=0", "tower", False, {}),
    "compile_retry": ("compile:raise@0+2", "tower", False, {}),
    "compile_demotes": ("compile:raise@0+3", "tower", False, {}),
    "compile_unrecoverable": ("compile:raise@0+6", "tower", False,
                              dict(compile_retries=1)),
    "kernel_nan_quarantine": ("kernel:nan@0+1~direct_lax", "tower", False,
                              {}),
    "kernel_raise_then_ok": ("kernel:raise@1+1", "tower", False, {}),
    "kernel_raise_exhausts": ("kernel:raise@0+9", "tower", False,
                              dict(kernel_retries=1)),
    "kernel_nan_pallas": ("kernel:nan@0+1~pallas", "stack64", True, {}),
}


@pytest.mark.parametrize("case", list(FAULT_PLANS))
def test_fault_plan_same_rungs_quarantines_and_answers(case):
    plan, net, kernels, kw = FAULT_PLANS[case]
    # stack64 serves pallas_direct_hwc at 32 x 32 (its bucket)
    c, hw = (32, 32) if net == "stack64" else (3, 16)
    requests = [("infer", _img(0, (c, hw, hw))),
                ("infer", _img(1, (c, hw - 2, hw))),
                ("batch", [_img(2, (c, hw, hw)), _img(3, (c, 12, 9))])]
    ref, port = servers(plan, net, kernels, **kw)
    try:
        want, got = _run(ref, requests), _run(port, requests)
        assert _state(port) == _state(ref)
        for g, w in zip(got, want):
            if isinstance(w, str):
                assert g == w  # the same typed failure
            else:
                _agree(g, w)
        if case in ("kernel_nan_quarantine", "kernel_nan_pallas"):
            s = port.stats()
            assert s["quarantines"] == 1
            target = "pallas_direct_hwc" if kernels else \
                "direct_lax_chw_chw_oihw"
            assert s["quarantined"][0].startswith(target)
            assert target not in _prims(port.plan_for((c, hw, hw)))
        if case == "compile_unrecoverable":
            assert got[0] == "InjectedFault"
        assert port.fault_injector.fired == ref.fault_injector.fired
    finally:
        ref.close()
        port.close()


def test_corrupt_plan_cache_re_solves_alike(tmp_path):
    x = _img(4)
    for srv in servers(cache_dir=tmp_path):
        srv.infer(x)
        srv.close()
    ref, port = servers("plan_cache:corrupt@0+1", cache_dir=tmp_path)
    _agree(port.infer(x), ref.infer(x))
    assert _state(port) == _state(ref)
    assert port.stats()["plan_cache_corrupt"] == 1
    ref.close()
    port.close()


def test_quarantine_release_recovers_the_original_plan_alike(tmp_path):
    x = _img(5)
    for srv in servers(cache_dir=tmp_path):
        srv.infer(x)
        srv.close()
    ref, port = servers("kernel:nan@0+1~direct_lax", cache_dir=tmp_path)
    for srv in (ref, port):
        srv.infer(x)
        assert srv.release_quarantine("direct_lax_chw_chw_oihw", x.shape)
        srv.infer(x)
    assert _state(port) == _state(ref)
    assert port.stats()["plan_disk_hits"] == 2
    ref.close()
    port.close()


def _nan_params(params):
    return {k: torch.full_like(v, float("nan")) if v.is_floating_point()
            else v for k, v in params.items()}


@pytest.mark.parametrize("batch", [1, 3])
def test_diagnose_nonfinite_blames_the_same_kernel(batch):
    rnet = r_tower((3, 16, 16), depth=2, width=4).with_batch(batch)
    tnet = t_tower((3, 16, 16), depth=2, width=4).with_batch(batch)
    rc, tc = _costs(False)
    rsel, tsel = RS.select_pbqp(rnet, rc), TS.select_pbqp(tnet, tc)
    assert _plan(tsel) == _plan(rsel)
    params = rnet.init_params(0)
    rcn = RPL.compile_plan(rsel, params, batch=batch)
    tcn = TPL.compile_plan(tsel, params, batch=batch, device="cpu")
    x = _img(6, (3, 16, 16) if batch == 1 else (batch, 3, 16, 16))
    assert r_diagnose(rcn, x) is None and t_diagnose(tcn, x) is None
    assert t_diagnose(tcn, np.full_like(x, np.nan)) is None  # bad input
    for conv in (n.id for n in tnet.conv_nodes()):
        tcn.params[conv] = _nan_params(tcn.params[conv])
        rcn.params[conv] = {k: np.full_like(np.asarray(v), np.nan)
                            for k, v in rcn.params[conv].items()}
        culprit = t_diagnose(tcn, x)
        assert culprit == r_diagnose(rcn, x) == \
            tsel.choices[conv].primitive.name


def test_a_crashing_walk_blames_the_same_kernel_on_the_cpu():
    """A maker that raises: on the CPU the port blames the conv being run,
    as the reference does (on the card it re-raises instead)."""
    rnet = r_tower((3, 16, 16), depth=2, width=4)
    tnet = t_tower((3, 16, 16), depth=2, width=4)
    rc, tc = _costs(False)
    rsel, tsel = RS.select_pbqp(rnet, rc), TS.select_pbqp(tnet, tc)
    params = rnet.init_params(0)
    rcn = RPL.compile_plan(rsel, params)
    tcn = TPL.compile_plan(tsel, params, device="cpu")
    conv = [n.id for n in tnet.conv_nodes()][-1]

    def broken(x, packed):
        raise RuntimeError("launch failed")

    rcn.makers[conv] = tcn.makers[conv] = broken
    x = _img(9)
    assert t_diagnose(tcn, x) == r_diagnose(rcn, x) == \
        tsel.choices[conv].primitive.name


def test_real_nan_is_attributed_and_quarantined_alike():
    x = _img(7)
    ref, port = servers()
    rcn, tcn = ref.compiled_for(x.shape), port.compiled_for(x.shape)
    conv = next(n.id for n in tcn.sel.net.conv_nodes())
    tcn.params[conv] = _nan_params(tcn.params[conv])
    rcn.params[conv] = {k: np.full_like(np.asarray(v), np.nan)
                        for k, v in rcn.params[conv].items()}
    _agree(port.infer(x), ref.infer(x))
    assert _state(port) == _state(ref)
    assert port.stats()["quarantines"] == 1
    ref.close()
    port.close()


def test_reference_selection_and_ladder_alike():
    rnet = r_tower((4, 16, 16), depth=2, width=4)
    tnet = t_tower((4, 16, 16), depth=2, width=4)
    rc, tc = _costs(False)
    rref, tref = r_reference(rnet, rc), t_reference(tnet, tc)
    assert _plan(tref) == _plan(rref)
    assert tref.predicted_cost == pytest.approx(rref.predicted_cost)
    assert _prims(tref) == ["sum2d"]
    x = _img(8, (4, 16, 16))
    params = rnet.init_params(0)
    _agree(TPL.compile_plan(tref, params, device="cpu")(x),
           RPL.compile_plan(rref, params)(x))
    rl = RLadder(rc, fault_injector=RInjector(r_parse("solve:raise@0+1")))
    tl = TLadder(tc, fault_injector=TInjector(t_parse("solve:raise@0+1")))
    for _ in range(2):
        (rs, rrung), (ts, trung) = rl.select(rnet, bucket="b"), \
            tl.select(tnet, bucket="b")
        assert trung == rrung and _plan(ts) == _plan(rs)
