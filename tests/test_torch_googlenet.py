"""GoogLeNet as the benchmark serves it (``bench/configs/googlenet.json``),
on the CPU: its layer list against the program's net and against Table
1's list in ``bench/tests``, ``PlanServer.infer_batch`` against the
benchmark's plain reference on both of the plan's routes, a broken join,
and the plan's counts of what one forward copies outside its convs.

The analytic model's batch-16 plan takes the card's route (K4, HWC
Winograd, every join in HWC) from 89 px up, 0.4 of the published size;
at the configuration's ``cpu_scale`` it is all CHW, as the batch-1 plan
is at every size.  So the batch-16 case runs at 0.4 and the batch-1 case
at ``cpu_scale``."""
import importlib.util
import json
import pathlib
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
sys.path[:0] = [str(BENCH), str(BENCH / "tests")]

import work  # noqa: E402
from reference import sequential  # noqa: E402
from test_bench_googlenet import googlenet_layers  # noqa: E402

from repro_torch.convnets import googlenet  # noqa: E402
from repro_torch.core import costs  # noqa: E402
from repro_torch.core.graph import Net, relu  # noqa: E402
from repro_torch.core.plan import compile_plan, layout_copies  # noqa: E402
from repro_torch.core.selection import select_pbqp  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.serving import BucketPolicy, PlanServer  # noqa: E402

CFG = json.loads((BENCH / "configs" / "googlenet.json").read_text())
LIMIT = json.loads((BENCH / "checks" / "googlenet.offline-b16.json")
                   .read_text())["logit_rel_err"]["limit"]
#: the smallest scale whose batch-16 plan takes the card's route
HWC_SCALE = 0.4
#: floats each image's nine joins write at 224 px (Table 1's concats)
JOIN_FLOATS = 1_235_584


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cost_model():
    sel = CFG["selector"]
    return costs.AnalyticCostModel(getattr(costs, sel["spec"]),
                                   include_kernels=sel["include_kernels"])


def test_the_list_is_the_programs_net():
    """Node by node: names, inputs and output shapes at 224 px."""
    net = googlenet(1.0)
    assert CFG["input"] == list(net.nodes["data"].out_shape)
    layers = work.layers(CFG["layers"], CFG["input"])
    assert [l.name for l in layers] == net.order[1:]
    for l in layers:
        node = net.nodes[l.name]
        assert l.out_shape == tuple(node.out_shape), l.name
        assert list(l.inputs or ("data",)) == node.inputs, l.name
    assert sum(l.op == "conv" for l in layers) == 57
    assert sum(l.op == "concat" for l in layers) == 9


def test_the_list_is_table_1s():
    """Entry by entry, the data file is the list written from Table 1."""
    table = googlenet_layers()
    assert len(CFG["layers"]) == len(table)
    for i, (mine, theirs) in enumerate(zip(CFG["layers"], table)):
        assert mine == theirs, (i, mine, theirs)


def roll_join(net: Net, join: str = "i4a_concat") -> Net:
    """``net`` with one concat's inputs rolled: the channels of its four
    branches land in the wrong order."""
    node = net.nodes[join]
    node.inputs = node.inputs[1:] + node.inputs[:1]
    return net


def serve(scale, n, seed, broken=False):
    """``n`` seeded images through ``PlanServer.infer_batch`` at batch
    bucket ``n`` and through the reference on the seed's weights: the
    server, the served plan and the logit-space error."""
    build = (lambda _s: roll_join(googlenet(scale))) if broken \
        else (lambda _s: googlenet(scale))
    policy = BucketPolicy(**CFG["bucket_policy"], min_n=n, max_n=n)
    srv = PlanServer(build, cost_model(), policy=policy, params_seed=seed,
                     device="cpu", exact=CFG["selector"]["solver"] == "pbqp")
    shape = tuple(googlenet(scale).nodes["data"].out_shape)
    xs = np.random.default_rng(seed).normal(
        size=(n, *shape)).astype(np.float32)
    out = srv.infer_batch(list(xs))
    params = sequential.to_device(
        sequential.init_params(CFG["layers"], shape, seed), "cpu")
    want = sequential.run(CFG["layers"], params, xs, "cpu", block=32)
    got = np.stack([o["prob"].reshape(-1) for o in out])
    return srv, srv.plan_for(shape, n), sequential.max_logit_err(got, want)


def prims(sel):
    return [c.primitive.name for c in sel.choices.values() if c.primitive]


def concat_layouts(sel):
    return {c.l_out for nid, c in sel.choices.items()
            if sel.net.nodes[nid].kind == "op"
            and sel.net.nodes[nid].op.name == "concat"}


ROUTES = {"b16-hwc": (HWC_SCALE, 16), "b1-chw": (CFG["cpu_scale"], 1)}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_served_agrees_with_the_reference(route):
    scale, n = ROUTES[route]
    srv, sel, err = serve(scale, n, 3_000_000_017)
    srv.close()
    assert err < LIMIT, err
    if n == 16:
        assert "pallas_direct_hwc" in prims(sel)
        assert concat_layouts(sel) == {"HWC"}
    else:
        assert all(c.l_in == c.l_out == "CHW" for c in sel.choices.values())
        assert concat_layouts(sel) == {"CHW"}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_a_broken_join_fails_the_comparison(route):
    scale, n = ROUTES[route]
    srv, _, err = serve(scale, n, 3_000_000_017, broken=True)
    srv.close()
    assert err > LIMIT, err


@pytest.mark.parametrize("n", [1, 16])
def test_the_published_plans_count_their_joins(n):
    """At 224 px: nine joins, each output element read and written once
    in float32; no edge of either plan converts a layout, so the only
    conversion is the batch-16 plan's probabilities, HWC to CHW."""
    sel = select_pbqp(googlenet(1.0).with_batch(n), cost_model())
    assert sel.conversions == {}
    lay = sel.choices["prob"].l_out
    got = layout_copies(sel, {"prob": lay}, n)
    assert got["joins"] == 9
    assert got["join_bytes"] == 2 * 4 * n * JOIN_FLOATS
    assert (lay, got["conversion_steps"], got["conversion_bytes"]) == \
        (("HWC", 1, 2 * 4 * n * 1000) if n == 16 else ("CHW", 0, 0))


def test_the_server_reports_each_plan_and_counts_its_copies():
    """``stats()["plans"]`` is the live executable's counts, the compile
    span carries them, and each forward advances ``layout_copy_bytes``."""
    spans = []
    obs_trace.configure(spans, enabled=True)
    try:
        srv, sel, _ = serve(HWC_SCALE, 16, 3_000_000_019)
    finally:
        obs_trace.configure(None, enabled=False)
    cnet = srv.compiled_for(tuple(sel.net.nodes["data"].out_shape), 16)
    srv.infer_batch([np.zeros(sel.net.nodes["data"].out_shape, np.float32)])
    s = srv.stats()
    srv.close()
    net = sel.net
    joins = [nid for nid in net.order if net.nodes[nid].kind == "op"
             and net.nodes[nid].op.name == "concat"]
    want = {"batch": 16, "joins": 9,
            "join_bytes": 2 * 4 * 16 * sum(np.prod(net.nodes[j].out_shape)
                                           for j in joins),
            "conversion_steps": 1, "conversion_bytes": 2 * 4 * 16 * 1000,
            "launches": {"conv_direct": prims(sel).count("pallas_direct_hwc")},
            "predicted_ms": 1e3 * sel.predicted_cost}
    assert s["plans"] == {"c3h89w89n16": want}
    assert s["layout_copy_bytes"] == 2 * cnet.layout_copy_bytes
    comp = next(sp for sp in spans if sp["name"] == "compile")
    assert {k: comp[k] for k in want if k != "batch"} == \
        {k: v for k, v in want.items() if k != "batch"}


class ForcedCosts(costs.AnalyticCostModel):
    """Prices only the named primitive per kernel size: a plan that must
    convert between its two convs."""
    PICK = {3: "direct_lax_chw_hwc_oihw", 1: "direct_lax_chw_chw_oihw"}

    def primitive_cost(self, p, scn):
        if p.name != self.PICK[scn.k]:
            return np.inf
        return super().primitive_cost(p, scn)


def two_convs(_shape=None) -> Net:
    net = Net("two_convs")
    x = net.input("data", (3, 8, 8))
    x = net.conv("a", x, k=3, m=8, pad=1)
    x = net.op("a_relu", [x], relu())
    net.conv("b", x, k=1, m=4, pad=0)
    return net


def test_a_forced_conversion_is_counted():
    """conv ``a`` writes HWC and conv ``b`` reads CHW: one step converts
    ``a``'s 8 x 8 x 8 output (or its ReLU's) per image, on an edge."""
    sel = select_pbqp(two_convs().with_batch(4), ForcedCosts())
    chains = list(sel.conversions.values())
    assert chains == [["HWC", "CHW"]]
    cnet = compile_plan(sel, sel.net.init_params(5), batch=4, device="cpu")
    step = 2 * 4 * 4 * 512
    assert (cnet.joins, cnet.join_bytes, cnet.conversion_steps,
            cnet.conversion_bytes) == (0, 0, 1, step)
    srv = PlanServer(two_convs, ForcedCosts(), device="cpu",
                     policy=BucketPolicy(spatial="exact", channel="exact",
                                         min_n=4, max_n=4))
    xs = list(np.random.default_rng(6).normal(size=(3, 3, 8, 8))
              .astype(np.float32))
    srv.infer_batch(xs)
    srv.infer_batch(xs[:1])
    s = srv.stats()
    srv.close()
    assert s["plans"]["c3h8w8n4"]["conversion_steps"] == 1
    assert s["plans"]["c3h8w8n4"]["conversion_bytes"] == step
    assert s["layout_copy_bytes"] == 2 * step


def load_reader(name):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"t_reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


PLAN = {"batch": 16, "joins": 9, "join_bytes": 2 * 4 * 16 * JOIN_FLOATS,
        "conversion_steps": 1, "conversion_bytes": 2 * 4 * 16 * 1000,
        "launches": {"conv_direct": 22}, "predicted_ms": 0.8}


def test_the_readers_read_the_plan_and_the_window():
    """``layout_copy_mb`` from the plan's counts; ``cost_model_ratio``
    from the window's device time less host copies and memsets, per
    forward (port kernel launches over one forward's), over the
    prediction; both None without the program's plans."""
    ops = {"(anonymous namespace)::conv_kernel<64>": (44, 0.5e-3),
           "void at::native::CatArrayBatchedCopy<...>": (18, 1.1e-3),
           "Memcpy HtoD (Pageable -> Device)": (2, 9.0e-3),
           "Memcpy DtoH (Device -> Pageable)": (2, 1.0e-3),
           "Memset (Device)": (4, 1.0e-3),
           "Memcpy DtoD (Device -> Device)": (2, 0.2e-3)}
    ctx = SimpleNamespace(setup_stats={"plans": {"c3h224w224n16": PLAN}},
                          device=SimpleNamespace(ops=ops),
                          kernel_launches_per_forward=22)
    mb = load_reader("layout_copy_mb")(ctx)
    assert mb == pytest.approx((JOIN_FLOATS + 1000) * 8 / 1e6)
    assert 9.89 < mb < 9.90
    ratio = load_reader("cost_model_ratio")(ctx)
    assert ratio == pytest.approx((1.8e-3 / 2) / 0.8e-3)
    parent = SimpleNamespace(setup_stats={"solve_s": 0.1},
                             device=ctx.device,
                             kernel_launches_per_forward=22)
    assert load_reader("layout_copy_mb")(parent) is None
    assert load_reader("cost_model_ratio")(parent) is None
