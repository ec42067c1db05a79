"""The port's cost models and selections against the reference's.

Costs are the same formulas on the same numbers, so they must be equal
— exactly — for every (primitive, scenario) pair: under ``CPU_SPEC``
with the kernel primitives unpriced (the reference's default), and under
the reference's ``TPU_V5E_SPEC`` fields with them priced.  Equal costs
over the same registry must then give identical PBQP choices,
conversions, fusions and predicted cost, or raise alike.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.convnets import NETWORKS as R_NETWORKS
from repro.core import costs as RC
from repro.core import primitives as RP
from repro.core import selection as RS
from repro_torch.convnets import NETWORKS as T_NETWORKS
from repro_torch.core import costs as TC
from repro_torch.core import primitives as TP
from repro_torch.core import selection as TS
from repro_torch.core.layouts import ALL_LAYOUTS

T_TPU_FIELDS = TC.HardwareSpec(**dataclasses.asdict(RC.TPU_V5E_SPEC))

MODELS = {
    "cpu": (lambda: RC.AnalyticCostModel(),
            lambda: TC.AnalyticCostModel()),
    "tpu_fields+kernels": (
        lambda: RC.AnalyticCostModel(RC.TPU_V5E_SPEC, include_tpu_only=True),
        lambda: TC.AnalyticCostModel(T_TPU_FIELDS, include_kernels=True)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    PyTorch's default of one thread per core would oversubscribe the
    machine under the timing-sensitive tests of the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scenarios(batch):
    seen = {}
    for name in ("alexnet", "googlenet", "vgg-a", "vgg-c"):
        for node in T_NETWORKS[name](1.0).with_batch(batch).conv_nodes():
            seen[node.scn.key()] = node.scn
    return list(seen.values())


def test_cpu_spec_is_the_reference_s():
    assert dataclasses.asdict(TC.CPU_SPEC) == dataclasses.asdict(RC.CPU_SPEC)
    assert TC.COST_MODEL_SCHEMA == RC.COST_MODEL_SCHEMA


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("batch", [1, 8])
def test_every_primitive_cost_is_equal(model, batch):
    rc, tc = (f() for f in MODELS[model])
    rreg = {p.name: p for p in RP.registry()}
    for scn in _scenarios(batch):
        rscn = RP.Scenario(**scn.__dict__)
        for p in TP.registry():
            got = tc.primitive_cost(p, scn)
            want = rc.primitive_cost(rreg[p.name], rscn)
            assert got == want or (np.isinf(got) and np.isinf(want)), \
                (p.name, scn.key(), got, want)
            for lay in p.fusable_in[:2]:
                assert tc.fused_in_cost(p, scn, lay) == \
                    rc.fused_in_cost(rreg[p.name], rscn, lay)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_transform_costs_are_equal(model):
    rc, tc = (f() for f in MODELS[model])
    for shape in [(96, 27, 27), (6, 5, 5), (256, 13, 13)]:
        for a in ALL_LAYOUTS:
            for b in ALL_LAYOUTS:
                assert tc.transform_cost(a.name, b.name, shape, np.float32) \
                    == rc.transform_cost(a.name, b.name, shape, np.float32)


def test_kernel_primitives_are_unpriced_by_default():
    cm = TC.AnalyticCostModel(TC.H100_SPEC)
    scn = T_NETWORKS["alexnet"](1.0).conv_nodes()[2].scn
    for p in TP.primitives_for(scn, families=["pallas"]):
        assert cm.primitive_cost(p, scn) == float("inf")
        assert np.isfinite(TC.AnalyticCostModel(
            TC.H100_SPEC, include_kernels=True).primitive_cost(p, scn))


def _summary(sel):
    return ({nid: (None if ch.primitive is None else ch.primitive.name,
                   ch.l_in, ch.l_out, ch.placement)
             for nid, ch in sel.choices.items()},
            sel.conversions, sel.fusions, sel.predicted_cost, sel.optimal,
            sel.strategy)


def _strategies():
    out = [("pbqp", lambda S, n, c: S.select_pbqp(n, c)),
           ("pbqp_fused", lambda S, n, c: S.select_pbqp(n, c, fuse=True)),
           ("sum2d", lambda S, n, c: S.select_sum2d(n, c)),
           ("local_optimal", lambda S, n, c: S.select_local_optimal(n, c))]
    for fam in ("direct", "im2", "winograd", "fft", "kn2", "pallas"):
        out.append((f"family_{fam}",
                    lambda S, n, c, fam=fam: S.select_family_best(n, c, fam)))
    return out


@pytest.mark.parametrize("strategy", _strategies(), ids=lambda s: s[0])
def test_selections_are_identical(strategy):
    """On alexnet@0.3 and googlenet@0.2, under both cost models."""
    _, run = strategy
    for name, scale in (("alexnet", 0.3), ("googlenet", 0.2)):
        rnet, tnet = R_NETWORKS[name](scale), T_NETWORKS[name](scale)
        assert tnet.fingerprint() == rnet.fingerprint()
        for model in sorted(MODELS):
            rc, tc = (f() for f in MODELS[model])
            try:
                want = _summary(run(RS, rnet, rc))
            except (ValueError, RuntimeError) as e:
                with pytest.raises(type(e)):
                    run(TS, tnet, tc)
                continue
            assert _summary(run(TS, tnet, tc)) == want, (name, model)


def test_main_path_selection_on_alexnet_227_is_the_reference_s():
    """AlexNet at full width under the H100 spec, kernels priced: the
    reference solves the same instance when handed the same fields, and
    the optimum runs the Winograd kernel on conv3..conv5."""
    spec = TC.H100_SPEC
    rsel = RS.select_pbqp(R_NETWORKS["alexnet"](1.0), RC.AnalyticCostModel(
        RC.HardwareSpec(**dataclasses.asdict(spec)), include_tpu_only=True))
    tsel = TS.select_pbqp(T_NETWORKS["alexnet"](1.0),
                          TC.AnalyticCostModel(spec, include_kernels=True))
    assert _summary(tsel) == _summary(rsel)
    picks = [tsel.choices[f"conv{i}"].primitive.name for i in (3, 4, 5)]
    assert all(p.startswith("pallas_wino") for p in picks)
