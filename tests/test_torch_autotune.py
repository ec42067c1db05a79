"""The port's autotuner (``repro_torch.autotune``, every kernel's
``space.py``, ``launch/tune.py``) against the reference's.

Mirrors tests/test_autotune.py.  The port's spaces are the CUDA kernels'
launch parameters (tile and cluster split count, flash attention's query
tile and KV split, the transpose's route), not the reference's TPU block
sizes, so their configurations differ; what must agree is the rest:

* every generated variant computes its hand-written entry's convolution:
  on the CPU each runs its plain version, held against the reference's
  Pallas entry in interpret mode (tests/test_torch_kernels.py runs them
  so) on small scenarios, in every layout pair of its fused builder,
  within 1e-4 of the largest magnitude (f32 sums in other orders over up
  to 4608 terms);
* the dominance pruner (a verbatim copy) keeps the reference's survivors
  on the same candidate costs;
* the catalog round-trips, and ``install()`` rotates every
  ``CostModel.version()`` and plan-cache key;
* the tuner is resumable and budget-capped, ``plan_only`` measures
  nothing, and the CLI dry-runs and writes a catalog on the CPU, where
  it prices with the card's fitted launch models (``analytic``).

No test here times anything: the CPU prices nothing of the card.
"""
import json
import pathlib
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.autotune import Candidate as RCandidate
from repro.autotune import prune_dominated as r_prune
from repro.core import primitives as r_prims
from repro.core.layouts import LAYOUT_BY_NAME as R_LAYOUTS
from repro.core.scenario import Scenario as RScenario
from repro_torch.autotune import (
    Candidate, VariantCatalog, analytic_measurer, generate_variants,
    kernel_spaces, plan_only, prune_dominated, spaces, tune, variant_name,
)
from repro_torch.autotune.measure import default_measure_mode
from repro_torch.calibrate import (CalibratedCostModel, scenario_grid,
                                   scenarios_from_net)
from repro_torch.convnets import alexnet
from repro_torch.core.costs import H100_SPEC, AnalyticCostModel
from repro_torch.core.layouts import LAYOUT_BY_NAME
from repro_torch.core.primitives import (
    build_registry, clear_extensions, extension_token, register_extension,
    registry, to_tensor, unregister_extension,
)
from repro_torch.core.scenario import Scenario
from repro_torch.core.selection import select_pbqp
from repro_torch.kernels.matmul.plan import (TILES, pin_gemm, plan_gemm,
                                             split_kslice)
from repro_torch.serving.bucketing import bucket_key
from repro_torch.serving.plan_cache import plan_key
from repro_torch.serving.towers import conv_tower, uniform_stack

pytestmark = pytest.mark.usefixtures("clean_registry")

REGISTERING = {"matmul": "pallas_pw_gemm_chw",
               "conv_im2col": "pallas_im2col_chw",
               "winograd_gemm": "pallas_wino_f{m_}x3_chw",
               "conv_direct": "pallas_direct_hwc"}
#: small scenarios: a short reduction (few split counts legal) and K =
#: 512, where every tile and split count is a legal plan
SCN_ARGS = {"matmul": [dict(c=8, h=10, w=10, stride=1, k=1, m=8, pad=0),
                       dict(c=512, h=4, w=4, stride=1, k=1, m=8, pad=0)],
            "conv_im2col": [dict(c=8, h=9, w=9, stride=2, k=3, m=8, pad=1),
                            dict(c=512, h=4, w=4, stride=1, k=1, m=8,
                                 pad=0)],
            "winograd_gemm": [dict(c=8, h=12, w=12, stride=1, k=3, m=8),
                              dict(c=512, h=5, w=5, stride=1, k=3, m=8)],
            "conv_direct": [dict(c=8, h=12, w=12, stride=1, k=3, m=8),
                            dict(c=512, h=4, w=4, stride=1, k=1, m=8,
                                 pad=0)]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def clean_registry():
    clear_extensions()
    yield
    clear_extensions()


def _tiny_tune(**kw):
    return tune(scenario_grid("small"), measure_mode="analytic",
                device="cpu", **kw)


# ----------------------------------------------------------------------
# parameter spaces
# ----------------------------------------------------------------------
class TestSpaces:
    def test_all_kernel_packages_declare_a_space(self):
        sp = spaces()
        assert set(sp) == {"matmul", "conv_direct", "conv_im2col",
                           "winograd_gemm", "flash_attention",
                           "layout_transform"}
        assert sum(s.registers for s in sp.values()) == 4
        assert len(kernel_spaces(None)) == 2

    def test_configs_are_valid_and_named_uniquely(self):
        for s in spaces().values():
            cfgs = s.configs()
            assert cfgs, s.kernel
            names = {s.make_primitive(c).name for c in cfgs} \
                if s.registers else \
                {variant_name(s.kernel, c, s.axis_order) for c in cfgs}
            assert len(names) == len(cfgs), s.kernel
            for c in cfgs:
                assert s.valid(c), (s.kernel, c)
                assert set(c) == set(s.axis_order)

    def test_axes_are_the_launch_planners(self):
        sp = spaces()
        for k in ("matmul", "conv_im2col"):
            assert sp[k].axes == (("tile", (0, 1, 2, 3)),
                                  ("splits", (1, 2, 4, 8)))
        assert sp["winograd_gemm"].axis_order == ("m_", "tile", "splits")
        assert sp["conv_direct"].axes == (("tile", (0, 1)),
                                          ("splits", (1, 2, 4, 8)))
        assert sp["flash_attention"].axes == (
            ("bq", (32, 64)), ("splits", tuple(range(1, 9))))
        assert len(sp["layout_transform"].configs()) == 3

    def test_generated_variants_carry_params_and_unique_names(self):
        variants = generate_variants()
        assert len(variants) == 16 + 16 + 32 + 8
        assert len({p.name for p in variants}) == len(variants)
        base = {p.name: p for p in build_registry()}
        for p in variants:
            assert p.params and p.family == "pallas"
            assert "@" in p.name and p.name not in base
            entry = base[p.name.split("@")[0]]
            assert p.tags == ("kernel", "autotuned")
            assert (p.l_in, p.l_out, p.fusable_in, p.fusable_out) == \
                (entry.l_in, entry.l_out, entry.fusable_in,
                 entry.fusable_out)
            assert p.prepare is entry.prepare

    def test_supports_is_the_entrys_and_a_legal_plan(self):
        """A variant supports a scenario where its entry does and its
        split count is a plan the planner could launch at that K."""
        space = spaces()["conv_im2col"]
        entry = next(p for p in build_registry()
                     if p.name == "pallas_im2col_chw")
        scns = scenario_grid("small") + scenarios_from_net(alexnet(1.0))
        for cfg in space.configs():
            prim = space.make_primitive(cfg)
            for scn in scns:
                k = scn.c * scn.k * scn.k
                legal = split_kslice(k, cfg["tile"], cfg["splits"]) \
                    is not None
                assert prim.supports(scn) == (entry.supports(scn)
                                              and legal), (prim.name, scn)
        short = Scenario(c=8, h=16, w=16, stride=1, k=1, m=8, pad=0)
        assert not space.make_primitive({"tile": 0, "splits": 2}) \
            .supports(short)

    def test_pinned_plans_are_the_planners_candidates(self):
        """Where the planner's own choice has a split count of the space,
        the variant pinned to it launches exactly the planner's plan; an
        illegal pin raises."""
        for m, n, k, b in [(96, 3025, 363, 1), (256, 729, 2400, 8),
                           (64, 3136, 64, 1), (384, 16, 2304, 36)]:
            own = plan_gemm(m, n, k, b)
            pinned = pin_gemm(m, n, k, b, tile=own.tile,
                              splits=own.splits)
            assert pinned == own
            for tile in range(len(TILES)):
                for splits in (1, 2, 4, 8):
                    if split_kslice(k, tile, splits) is None:
                        with pytest.raises(ValueError, match="legal"):
                            pin_gemm(m, n, k, b, tile=tile, splits=splits)
                    else:
                        p = pin_gemm(m, n, k, b, tile=tile, splits=splits)
                        assert (p.tile, p.splits) == (tile, splits)
                        assert p.kslice * splits >= k

    def test_other_packages_parameters_are_refused(self):
        """A reference catalog's TPU block sizes name no launch here."""
        for kname in REGISTERING:
            with pytest.raises(ValueError, match="re-run the tuner"):
                spaces()[kname].make_primitive({"bm": 128, "bn": 128,
                                                "bk": 128})


# ----------------------------------------------------------------------
# every variant's convolution against the reference's Pallas entry
# ----------------------------------------------------------------------
_REF_CACHE = {}


def _draws(args):
    scn = Scenario(**args)
    rng = np.random.default_rng(scn.c * 1000 + scn.h * 10 + scn.k)
    x = rng.normal(size=scn.in_shape_chw).astype(np.float32)
    w = (rng.normal(size=scn.weight_shape) * 0.1).astype(np.float32)
    b = rng.normal(size=(scn.m,)).astype(np.float32)
    return x, w, b


def _reference(name, args, l_in, l_out):
    """The reference's hand-written Pallas entry (interpret mode), in
    logical CHW."""
    key = (name, tuple(sorted(args.items())), l_in, l_out)
    if key not in _REF_CACHE:
        rprim = next(p for p in r_prims.registry() if p.name == name)
        scn = RScenario(**args)
        x, w, b = _draws(args)
        packed = rprim.prepare(scn, w, b)
        y = rprim.make_fused(scn, l_in=l_in, l_out=l_out)(
            jnp.asarray(R_LAYOUTS[l_in].to_memory(x)), packed)
        _REF_CACHE[key] = R_LAYOUTS[l_out].from_memory(
            np.asarray(y, np.float32))
    return _REF_CACHE[key]


def _layout_pairs(prim):
    ins = (prim.l_in,) + tuple(prim.fusable_in)
    outs = (prim.l_out,) + tuple(prim.fusable_out)
    return [(a, b) for a in ins for b in outs]


@pytest.mark.parametrize("kernel", sorted(REGISTERING))
@pytest.mark.parametrize("pair", range(4))
def test_every_variant_matches_the_reference_entry(kernel, pair):
    """Every configuration of the space, on every small scenario it
    supports, in layout pair ``pair`` of its fused builder (native in
    and out, then the fused ones), batched and single-image."""
    space = spaces()[kernel]
    tested = set()
    for cfg in space.configs():
        prim = space.make_primitive(cfg)
        l_in, l_out = _layout_pairs(prim)[pair]
        entry = prim.name.split("@")[0]
        for args in SCN_ARGS[kernel]:
            scn = Scenario(**args)
            if not prim.supports(scn):
                continue
            want = _reference(entry, args, l_in, l_out)
            x, w, b = _draws(args)
            packed = {k: to_tensor(v) for k, v in
                      prim.prepare(scn, w, b).items()}
            xin = to_tensor(LAYOUT_BY_NAME[l_in].to_memory(x))
            f = prim.make_fused(scn, l_in=l_in, l_out=l_out)
            for batched in (False, True):
                y = f(xin.unsqueeze(0), packed)[0] if batched else \
                    f(xin, packed)
                got = LAYOUT_BY_NAME[l_out].from_memory(y.numpy())
                assert got.shape == want.shape, prim.name
                err = float(np.abs(got - want).max())
                assert err <= 1e-4 * float(np.abs(want).max()), \
                    (prim.name, args, l_in, l_out, err)
            tested.add(prim.name)
    assert len(tested) == len(space.configs())


# ----------------------------------------------------------------------
# registry extension
# ----------------------------------------------------------------------
class TestRegistryExtension:
    def test_register_unregister_roundtrip(self):
        n0 = len(registry())
        space = spaces()["conv_im2col"]
        prim = space.make_primitive(space.configs()[0])
        register_extension("t", (prim,), token="abc")
        assert len(registry()) == n0 + 1
        assert extension_token() == "t:abc"
        assert unregister_extension("t")
        assert len(registry()) == n0
        assert extension_token() == ""
        assert not unregister_extension("t")

    def test_duplicate_names_rejected(self):
        base = registry()[0]
        with pytest.raises(ValueError, match="duplicate"):
            register_extension("dup", (base,))
        space = spaces()["conv_im2col"]
        prim = space.make_primitive(space.configs()[0])
        register_extension("a", (prim,))
        with pytest.raises(ValueError, match="duplicate"):
            register_extension("b", (prim,))

    def test_cost_model_version_rotates_with_extensions(self):
        cm = AnalyticCostModel(H100_SPEC, include_kernels=True)
        v0 = cm.version()
        space = spaces()["conv_im2col"]
        prim = space.make_primitive(space.configs()[0])
        register_extension("t", (prim,), token="abc")
        v1 = cm.version()
        assert v1 != v0
        register_extension("t2", (space.make_primitive(
            space.configs()[1]),), token="xyz")
        assert cm.version() not in (v0, v1)
        clear_extensions()
        assert cm.version() == v0


# ----------------------------------------------------------------------
# dominance pruning: the verbatim pruner, against the reference's
# ----------------------------------------------------------------------
def _cand(name, costs, prunable=True, group="g"):
    return Candidate(name=name, prunable=prunable,
                     group=(group, tuple(sorted(costs))),
                     costs=tuple(sorted(costs.items())))


def _both(cands):
    """Survivors and pruned map from both packages' pruners."""
    rc = [RCandidate(c.name, c.prunable, c.group, c.costs) for c in cands]
    got, want = prune_dominated(cands), r_prune(rc)
    assert got[0] == want[0] and got[1] == want[1]
    return got


def _random_cands(draw):
    buckets = [f"b{i}" for i in range(1 + draw(3))]
    support = tuple(buckets[:1 + draw(len(buckets))])
    costs_alphabet = (1.0, 2.0, 4.0, 8.0)
    return [_cand(f"c{i}", {b: costs_alphabet[draw(4)] for b in support},
                  prunable=bool(draw(4)))
            for i in range(2 + draw(5))]


class TestPruning:
    def test_dominated_variant_pruned_with_dominator_recorded(self):
        a = _cand("a", {"b0": 1.0, "b1": 1.0})
        b = _cand("b", {"b0": 2.0, "b1": 1.0})
        assert _both([a, b]) == (["a"], {"b": "a"})

    def test_pareto_incomparable_both_survive(self):
        a = _cand("a", {"b0": 1.0, "b1": 3.0})
        b = _cand("b", {"b0": 3.0, "b1": 1.0})
        assert _both([a, b]) == (["a", "b"], {})

    def test_handwritten_never_pruned_and_wins_ties(self):
        base = _cand("zz_base", {"b0": 1.0}, prunable=False)
        tied = _cand("aa_variant", {"b0": 1.0})
        worse = _cand("mm_variant", {"b0": 2.0})
        survivors, pruned = _both([base, tied, worse])
        assert survivors == ["zz_base"]
        assert pruned["aa_variant"] == "zz_base"
        assert set(pruned) == {"aa_variant", "mm_variant"}

    def test_different_groups_never_compared(self):
        a = _cand("a", {"b0": 1.0}, group="g1")
        b = _cand("b", {"b0": 9.0}, group="g2")
        assert _both([a, b])[0] == ["a", "b"]

    def test_unmeasured_candidate_not_used_as_dominator(self):
        survivors, pruned = _both([_cand("empty", {}),
                                   _cand("a", {"b0": 5.0})])
        assert "a" in survivors and "a" not in pruned

    def test_random_candidates_prune_as_the_reference(self):
        """Seeded random tournaments: the same survivors and dominators
        as the reference's pruner, in any candidate order."""
        rng = np.random.default_rng(7)
        for _ in range(300):
            cands = _random_cands(lambda n: int(rng.integers(n)))
            survivors, pruned = _both(cands)
            assert set(survivors) | set(pruned) == {c.name for c in cands}
            order = rng.permutation(len(cands))
            s2, p2 = _both([cands[i] for i in order])
            assert survivors == s2 and set(pruned) == set(p2)

    def test_tuned_candidates_prune_as_the_reference(self):
        """The candidates of a real (analytic) tune, fed to both."""
        res = _tiny_tune()
        pool = generate_variants() + [p for p in registry()
                                      if p.family == "pallas"
                                      and not p.params]
        from repro_torch.autotune import candidates_from_costs
        from repro_torch.core.costs import prim_cost_key
        cands = candidates_from_costs(
            pool, scenario_grid("small"),
            lambda p, s: res.profile.get(prim_cost_key(p.name, s)))
        survivors, pruned = _both(cands)
        assert survivors == sorted(
            [c.name for c in cands if not c.prunable]
            + res.catalog.survivors()
            + [n for n, e in res.catalog.variants.items()
               if not e["costs"]])

    def test_pruning_never_changes_the_pbqp_optimum(self):
        """Solving over survivors-only under the tune's own prices equals
        solving over the whole candidate pool."""
        net = uniform_stack((256, 16, 16), depth=2, k=1)
        scns = scenarios_from_net(net, batches=(1,))
        res = tune(scns, kernels=("matmul",), measure_mode="analytic",
                   device="cpu")
        cost = CalibratedCostModel(res.profile, check_device=False,
                                   exclude_tags=())
        surv = res.catalog.build_primitives()
        assert res.pruned > 0
        register_extension("all", tuple(generate_variants(
            kernels=("matmul",))))
        full = select_pbqp(net, cost)
        clear_extensions()
        register_extension("surv", tuple(surv))
        lean = select_pbqp(net, cost)
        assert lean.predicted_cost == pytest.approx(full.predicted_cost,
                                                    rel=1e-9)


# ----------------------------------------------------------------------
# the analytic measurer: the card's fitted launch models
# ----------------------------------------------------------------------
class TestAnalyticMeasurer:
    def test_ranks_variants_of_one_kernel_apart(self):
        """At an AlexNet bucket two variants of one kernel price apart,
        and none below the hand-written entry (the planner's own choice
        minimises the same model)."""
        scns = scenarios_from_net(alexnet(1.0), batches=(1,))
        variants, items, index = plan_only(scns, device="cpu")
        measure = analytic_measurer(index)
        by_item = {it.key: measure(it) for it in items}
        conv2 = scns[1]
        prices = {e[1].name: by_item[k] for k, e in index.items()
                  if e[0] == "prim" and e[2] == conv2
                  and e[1].name.startswith("pallas_im2col_chw")}
        base = prices.pop("pallas_im2col_chw")
        assert len(set(prices.values())) > 1
        assert min(prices.values()) == pytest.approx(base, rel=1e-12)
        assert all(p >= base * (1 - 1e-12) for p in prices.values())
        # the entry prices as the H100 model with the kernels priced
        entry = next(p for p in registry() if p.name == "pallas_im2col_chw")
        assert base == AnalyticCostModel(
            H100_SPEC, include_kernels=True).primitive_cost(entry, conv2)

    def test_kernel_only_items_price_by_their_spaces(self):
        scns = scenarios_from_net(alexnet(1.0), batches=(1,))
        _, items, index = plan_only(scns, device="cpu")
        measure = analytic_measurer(index)
        fa = {index[it.key][2]["splits"]: measure(it) for it in items
              if it.key.startswith("kernel::flash_attention@bq64_")
              and index[it.key][3] == scns[0]}
        assert len(fa) == 8 and len(set(fa.values())) > 1
        lt = [measure(it) for it in items
              if it.key.startswith("kernel::layout_transform@")
              and index[it.key][3] == scns[0]]
        assert len(lt) == 2 and lt[0] == lt[1]  # conv1: tile, short rows

    def test_measure_mode_follows_the_device(self):
        assert default_measure_mode("cpu") == "analytic"
        with pytest.raises(ValueError, match="plain versions"):
            tune(scenario_grid("tiny"), measure_mode="real", device="cpu")

    def test_the_card_is_the_default(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default is the card")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tune(scenario_grid("tiny"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            default_measure_mode()


# ----------------------------------------------------------------------
# catalog
# ----------------------------------------------------------------------
class TestCatalog:
    def test_roundtrip_and_install(self, tmp_path):
        res = _tiny_tune()
        cat = res.catalog
        assert res.generated == len(cat.variants) > 0
        assert cat.survivors()
        path = tmp_path / "cat.json"
        cat.save(path)
        loaded = VariantCatalog.load(path)
        assert loaded.content_hash() == cat.content_hash()
        assert loaded.survivors() == cat.survivors()
        n0 = len(registry())
        n = loaded.install()
        assert n == len(cat.survivors())
        assert len(registry()) == n0 + n
        assert cat.content_hash() in extension_token()
        assert VariantCatalog.uninstall()
        assert len(registry()) == n0

    def test_install_rotates_cost_versions_and_plan_keys(self):
        net = conv_tower((32, 32, 32), depth=2, width=32)
        cm = AnalyticCostModel(H100_SPEC, include_kernels=True)
        bkey = bucket_key((32, 32, 32), 1)
        k0 = plan_key(net.fingerprint(), bkey, cm.version())
        res = _tiny_tune()
        res.catalog.install()
        k1 = plan_key(net.fingerprint(), bkey, cm.version())
        assert k1 != k0
        VariantCatalog.uninstall()
        assert plan_key(net.fingerprint(), bkey, cm.version()) == k0

    def test_schema_mismatch_rejected(self):
        payload = _tiny_tune().catalog.to_payload()
        payload["schema"] = 999
        with pytest.raises(ValueError, match="schema"):
            VariantCatalog.from_payload(payload)

    def test_stale_parameter_space_rejected(self):
        cat = _tiny_tune().catalog
        entry = cat.variants[cat.survivors()[0]]
        entry["params"] = dict(entry["params"], splits=3)
        with pytest.raises(ValueError, match="re-run the tuner"):
            cat.build_primitives()

    def test_kernel_only_winners_recorded(self):
        res = _tiny_tune()
        keys = list(res.catalog.kernels)
        assert any(k.startswith("flash_attention::") for k in keys)
        assert any(k.startswith("layout_transform::") for k in keys)
        for e in res.catalog.kernels.values():
            assert e["seconds"] > 0 and e["params"]


# ----------------------------------------------------------------------
# tuner + CLI
# ----------------------------------------------------------------------
class TestTuner:
    def test_budget_caps_and_resumes(self, tmp_path):
        prof_path = tmp_path / "p.json"
        res = _tiny_tune(budget=25, profile_path=prof_path)
        assert res.sweep["measured"] == 25
        assert res.sweep["remaining"] > 0
        res2 = _tiny_tune(profile=res.profile, profile_path=prof_path)
        assert res2.sweep["skipped"] == 25
        assert res2.sweep["remaining"] == 0
        assert res2.surviving >= 1

    def test_plan_only_measures_nothing(self):
        variants, items, index = plan_only(scenario_grid("small"))
        assert len(items) == len(index) > 0 and len(variants) > 0
        prim_keys = [k for k, e in index.items() if e[0] == "prim"]
        assert all(k.startswith("prim::") for k in prim_keys)

    def test_cli_dry_run(self, capsys):
        from repro_torch.launch.tune import main
        assert main(["--catalog", "/nonexistent/never-written.json",
                     "--grid", "tiny", "--device", "cpu",
                     "--dry-run"]) == 0
        out = capsys.readouterr().out
        assert "dry run: nothing measured, nothing written" in out
        assert not pathlib.Path("/nonexistent").exists()

    def test_cli_needs_a_card_unless_told(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default is the card")
        from repro_torch.launch.tune import main
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--catalog", str(tmp_path / "c.json"), "--dry-run"])

    def test_cli_cpu_run_writes_catalog(self, tmp_path, capsys):
        from repro_torch.launch.tune import main
        cat = tmp_path / "cat.json"
        argv = ["--catalog", str(cat), "--grid", "small", "--device",
                "cpu"]
        assert main(argv) == 0
        assert cat.exists() and cat.with_suffix(".profile.json").exists()
        loaded = VariantCatalog.load(cat)
        assert json.loads(cat.read_text())["schema"] == 1
        assert loaded.measure == "analytic" and loaded.survivors()
        n0 = len(registry())
        assert loaded.install() >= 1
        assert len(registry()) > n0
        # re-run resumes: everything covered, nothing new measured
        clear_extensions()
        assert main(argv) == 0
        assert "measured 0," in capsys.readouterr().out


# ----------------------------------------------------------------------
# anytime solve over the widened registry
# ----------------------------------------------------------------------
class TestAnytimeOnWidenedRegistry:
    def test_deadline_respected_with_near_optimal_cost(self):
        """With the tuned catalog installed the anytime solver returns by
        its deadline with an incumbent within 10% of the exact optimum."""
        net = conv_tower((32, 32, 32), depth=3, width=32)
        cost = AnalyticCostModel(H100_SPEC, include_kernels=True)
        res = tune(scenario_grid("small")
                   + scenarios_from_net(net, batches=(1,)),
                   measure_mode="analytic", device="cpu")
        assert res.catalog.install() >= 1
        assert len(registry()) > 72
        exact = select_pbqp(net, cost)
        deadline = 0.5
        t0 = time.perf_counter()
        anytime = select_pbqp(net, cost, deadline_s=deadline)
        wall = time.perf_counter() - t0
        assert wall <= deadline + 0.5
        assert anytime.predicted_cost <= 1.1 * exact.predicted_cost
