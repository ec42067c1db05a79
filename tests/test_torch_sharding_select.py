"""The port's PBQP sharding selection (``repro_torch.core.sharding_select``)
and its ``Rules`` against the reference's, on the CPU.

The two packages price the same instance with the same formulas, so for
every ``(arch, shape)`` of ``cells()`` on every mesh below, given
``HardwareSpec``s of the same fields, the assignment, the domains and
``optimal`` must be identical and ``predicted_comm_s`` equal within
1e-12 relative (sums in the same order: equal in practice).  Also the
reference's own ``tests/test_sharding_select.py`` cases, on its
``TPU_V5E_SPEC`` figures carried into the port's ``HardwareSpec`` (the
port's default is ``H100_SPEC``), its golden snapshot, and the port's
default on the H100 figures.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest

from repro.configs import SHAPES as R_SHAPES
from repro.configs import cells
from repro.configs import get_config as r_config
from repro.core import costs as RC
from repro.core.sharding_select import select_rules as r_select
from repro.models.sharding import MEGATRON_RULES as R_MEGATRON
from repro.models.sharding import Rules as RRules
from repro_torch.configs import SHAPES, get_config
from repro_torch.core import costs as TC
from repro_torch.core.sharding_select import (
    ShardingChoice, candidate_report, select_rules,
)
from repro_torch.models.sharding import MEGATRON_RULES, Rules

MESH_1POD = {"data": 16, "model": 16}
MESH_2POD = {"pod": 2, "data": 16, "model": 16}
MESHES = {"1pod": MESH_1POD, "2pod": MESH_2POD,
          "data2_model2": {"data": 2, "model": 2}, "model4": {"model": 4}}
#: the same fields in both packages: the port's H100 figures, and the
#: reference's TPU figures
T_TPU = TC.HardwareSpec(**dataclasses.asdict(RC.TPU_V5E_SPEC))
R_H100 = RC.HardwareSpec(**dataclasses.asdict(TC.H100_SPEC))
SPECS = {"h100": (R_H100, TC.H100_SPEC), "tpu": (RC.TPU_V5E_SPEC, T_TPU)}
GOLDEN = json.loads((pathlib.Path(__file__).parent / "data" /
                     "sharding_golden.json").read_text())
GOLDEN_MESHES = {"1pod": MESH_1POD, "2pod": MESH_2POD}
CELLS = [(a, s) for a, s, _ in cells()]


def _rules_table(rules):
    return tuple((k, v) for k, v in rules.table)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_select_rules_matches_reference(arch, shape, mesh):
    for r_spec, t_spec in SPECS.values():
        r_rules, r_rep = r_select(r_config(arch), R_SHAPES[shape],
                                  MESHES[mesh], spec=r_spec)
        t_rules, t_rep = select_rules(get_config(arch), SHAPES[shape],
                                      MESHES[mesh], spec=t_spec)
        for k in ("assignment", "domains", "optimal", "spec", "mesh",
                  "arch", "shape"):
            assert t_rep[k] == r_rep[k], (k, t_rep[k], r_rep[k])
        assert t_rep["predicted_comm_s"] == pytest.approx(
            r_rep["predicted_comm_s"], rel=1e-12)
        assert _rules_table(t_rules) == _rules_table(r_rules)


def test_default_spec_is_the_h100():
    _, rep = select_rules(get_config("tinyllama-1.1b"), SHAPES["train_4k"],
                          MESH_1POD)
    assert rep["spec"] == TC.H100_SPEC.name
    assert candidate_report(get_config("tinyllama-1.1b"),
                            SHAPES["train_4k"], MESH_1POD) == rep


@pytest.mark.parametrize("mesh", [{"data": 2, "model": 2}, {"model": 2},
                                  {"data": 2, "model": 4}])
@pytest.mark.parametrize("shape", ["prefill_4x1024", "decode_4at1040",
                                   "train_8x256"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "jamba-v0.1-52b"])
def test_card_meshes_pick_head_parallel_attention(arch, shape, mesh):
    """On the card's meshes the port's default picks the sharded heads
    (K6 on each rank's share of them), Megatron FFNs, a replicated
    stream and embedding, the vocab-sharded head and, at decode, the
    batch-sharded cache."""
    kind, rest = shape.split("_")
    if kind == "decode":
        b, t = (int(x) for x in rest.split("at"))
    else:
        b, t = (int(x) for x in rest.split("x"))
    shp = dataclasses.replace(SHAPES["train_4k"], name=shape, seq_len=t,
                              global_batch=b, kind=kind)
    _, rep = select_rules(get_config(arch), shp, mesh)
    want = {"embed": "embed:rep", "attn": "attn:heads", "ffn": "ffn:tp",
            "stream": "stream:rep", "head": "head:vocab"}
    if kind == "decode":
        want["cache"] = "cache:batch"
    assert rep["assignment"] == want


# ---------------------------------------------------------------------
# the reference's own cases, on its TPU figures
# ---------------------------------------------------------------------
def _sel(arch, shape, mesh, spec=T_TPU):
    return select_rules(get_config(arch), SHAPES[shape], mesh, spec=spec)


class TestFeasibility:
    def test_whisper_heads_not_divisible_falls_back(self):
        rules, report = _sel("whisper-large-v3", "train_4k", MESH_1POD)
        assert report["assignment"]["attn"] != "attn:heads"
        assert rules.get("heads") != "model"

    def test_llava_56_heads_not_divisible(self):
        rules, report = _sel("llava-next-34b", "train_4k", MESH_1POD)
        assert report["assignment"]["attn"] in ("attn:head_dim",
                                                "attn:rep")

    def test_dense_picks_megatron_tp(self):
        rules, report = _sel("mistral-nemo-12b", "train_4k", MESH_1POD)
        assert report["assignment"]["attn"] == "attn:heads"
        assert report["assignment"]["ffn"] == "ffn:tp"
        assert rules.get("heads") == "model"

    def test_grok_8_experts_use_tp_within_expert(self):
        rules, report = _sel("grok-1-314b", "train_4k", MESH_1POD)
        assert report["assignment"]["ffn"] == "ffn:tp"

    def test_kimi_384_experts_can_use_ep(self):
        rules, report = _sel("kimi-k2-1t-a32b", "train_4k", MESH_1POD)
        assert report["assignment"]["ffn"] in ("ffn:ep", "ffn:tp")
        assert "ffn:ep" in report["domains"]["ffn"]

    def test_mamba_vocab_not_divisible(self):
        rules, report = _sel("mamba2-2.7b", "train_4k", MESH_1POD)
        assert report["assignment"]["embed"] != "embed:vocab"

    def test_long_context_decode_shards_kv_seq(self):
        rules, report = _sel("jamba-v0.1-52b", "long_500k", MESH_1POD)
        assert report["assignment"]["cache"] == "cache:seq"
        assert rules.get("kv_seq") is not None

    def test_batched_decode_prefers_batch_sharded_cache(self):
        rules, report = _sel("mistral-nemo-12b", "decode_32k", MESH_1POD)
        assert report["assignment"]["cache"] == "cache:batch"


class TestSolverProperties:
    @pytest.mark.parametrize("arch", ["mistral-nemo-12b", "gemma2-9b",
                                      "kimi-k2-1t-a32b", "mamba2-2.7b",
                                      "whisper-large-v3"])
    @pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
    @pytest.mark.parametrize("spec", ["h100", "tpu"])
    def test_always_solves_optimally(self, arch, shape, spec):
        rules, report = _sel(arch, shape, MESH_2POD, SPECS[spec][1])
        assert report["optimal"]
        assert np.isfinite(report["predicted_comm_s"])

    def test_multi_pod_batch_uses_pod_axis(self):
        rules, _ = _sel("tinyllama-1.1b", "train_4k", MESH_2POD)
        batch_axes = rules.get("batch")
        assert "pod" in (batch_axes if isinstance(batch_axes, tuple)
                         else (batch_axes,))


class TestCostEquivalence:
    @pytest.mark.parametrize("key", sorted(GOLDEN))
    def test_matches_reference_golden(self, key):
        arch, sname, mname = key.split("|")
        _, rep = _sel(arch, sname, GOLDEN_MESHES[mname])
        want = GOLDEN[key]
        assert rep["assignment"] == want["assignment"]
        assert rep["predicted_comm_s"] == pytest.approx(
            want["predicted_comm_s"], rel=1e-12)

    def test_no_fabric_spec_replicates_instead_of_crashing(self):
        no_fabric = TC.HardwareSpec(name="no-fabric",
                                    peak_flops=TC.H100_SPEC.peak_flops,
                                    mem_bw=TC.H100_SPEC.mem_bw)
        _, rep = _sel("mistral-nemo-12b", "train_4k", MESH_1POD, no_fabric)
        assert rep["optimal"]
        assert np.isfinite(rep["predicted_comm_s"])
        for group, choice in rep["assignment"].items():
            assert choice.endswith(":rep"), (group, choice)

    def test_spec_reprices_the_instance(self):
        slow = dataclasses.replace(TC.H100_SPEC, name="h100-slow-links",
                                   link_bw=TC.H100_SPEC.link_bw / 100)
        _, fast = _sel("mistral-nemo-12b", "train_4k", MESH_1POD,
                       TC.H100_SPEC)
        _, slow_rep = _sel("mistral-nemo-12b", "train_4k", MESH_1POD, slow)
        assert slow_rep["spec"] == "h100-slow-links"
        assert slow_rep["predicted_comm_s"] > fast["predicted_comm_s"]

    def test_return_solution(self):
        rules, rep, sol = select_rules(
            get_config("tinyllama-1.1b"), SHAPES["train_4k"], MESH_1POD,
            return_solution=True)
        assert sol.cost == rep["predicted_comm_s"] and sol.optimal
        assert ShardingChoice("x", ()).stream == "rep"


class TestRules:
    def test_restrict_drops_missing_axes(self):
        r = Rules((("batch", ("pod", "data")), ("heads", "model")))
        r2 = r.restrict(["data", "model"])
        assert r2.get("batch") == "data"
        assert r2.get("heads") == "model"
        assert r.restrict(["model"]).get("batch") is None

    def test_spec_dedups_mesh_axes(self):
        r = Rules((("a", "model"), ("b", "model")))
        spec = r.spec(("a", "b"))
        flat = [x for part in spec if part
                for x in ((part,) if isinstance(part, str) else part)]
        assert flat.count("model") == 1

    def test_feasible_divisibility(self):
        r = MEGATRON_RULES
        assert r.feasible(("d_model", "heads"), (512, 32),
                          {"data": 16, "model": 16, "pod": 1})
        assert not r.feasible(("d_model", "heads"), (512, 20),
                              {"data": 16, "model": 16, "pod": 1})

    @pytest.mark.parametrize("mesh", ["1pod", "2pod", "data2_model2",
                                      "model4"])
    def test_with_restrict_feasible_match_reference(self, mesh):
        names = list(MESHES[mesh])
        kw = dict(kv_heads=None, batch=("pod", "data"), seq="model")
        t = MEGATRON_RULES.with_(**kw).restrict(names)
        r = R_MEGATRON.with_(**kw).restrict(names)
        assert _rules_table(t) == _rules_table(r)
        for axes, shape in [(("batch", "seq", "heads"), (32, 64, 20)),
                            (("d_model", "d_ff"), (4096, 14336)),
                            (("vocab", "d_model"), (50280, 2560))]:
            ms = dict(MESHES[mesh], pod=MESHES[mesh].get("pod", 1))
            assert t.feasible(axes, shape, ms) == \
                RRules(r.table).feasible(axes, shape, ms)
            assert t.spec(axes) == tuple(r.spec(axes))
