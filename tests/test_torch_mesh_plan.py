"""The port's mesh-sharded executables (``compile_plan(..., mesh=)``)
against the reference's, on the CPU.

The port's side runs in gloo worlds of CPU processes (``run_spmd``), one
world per mesh: ``(8,)`` over ``data``, ``(2, 4)`` over ``data`` x
``model`` and ``(4,)`` over ``stage``.  The reference's side runs once,
in one subprocess on 8 fake CPU devices (``_torch_mesh_cases.reference``).
The cases are the reference's own mesh cases (``tests/test_distributed.py``):
the sharded towers (``shard_map`` and ``gspmd``), the mixed tp+dp plan
(``tp_shard_map``), the solved pipeline and pure dp over both batch
meshes.  Per case:

* the mode and the dp/tp/pp node counts equal the reference's, and so
  do the solved placements and primitives (the port's selection modules
  are the reference's, byte for byte);
* every rank returns the full outputs, and they are the same on every
  rank;
* the net's outputs lie within ``REF_REL`` (1e-3) of the reference
  mesh executable's largest magnitude;
* every conv's output and every sink lie within ``SELF_REL`` (1e-5) of
  the port's own single-device executable of the same selection's
  largest magnitude.  Each rank's shard runs the same primitives on
  fewer images, whose GEMMs block and sum in other orders.  Measured:
  5.5e-6 for pure dp (Winograd F(6,3) on conv1-conv2, whose transforms
  amplify that rounding, over 1 image against 8), 4.9e-7 for the gspmd
  tower, 4.2e-7 for the tp plan and 6.3e-7 for the pipeline
  (microbatches of 2 images).

The validation of ``compile_plan(mesh=)`` needs no world: stand-in meshes
carry the axes, and the port must raise the reference's ``ValueError``
with the reference's message.  Two ranks that compile different plans
must raise, well inside the process group's timeout, instead of hanging.
"""
import dataclasses
import time
import types

import numpy as np
import pytest
import torch

import _torch_mesh_cases as C
from repro.core import plan as RP
from repro.core.costs import AnalyticCostModel as RCost
from repro.core.selection import select_pbqp as r_select
from repro.serving import towers as r_towers
from repro_torch.core import plan as TP
from repro_torch.core.costs import AnalyticCostModel as TCost
from repro_torch.core.selection import select_pbqp as t_select
from repro_torch.launch.mesh import run_spmd
from repro_torch.serving import towers as t_towers

REF_REL = 1e-3
SELF_REL = 1e-5
#: a collective that another rank never joins fails after this long
TIMEOUT_S = 60.0
#: the worlds: mesh -> its cases
WORLDS = {
    "data8": ("conv_stack_data8", "conv_tower_data8"),
    "data2_model4": ("bottleneck_data2_model4", "conv_stack_data2_model4"),
    "stage4": ("uniform_stack_stage4",),
}
WORLD_OF = {case: w for w, cases in WORLDS.items() for case in cases}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return C.reference("plan", tmp_path_factory.mktemp("ref_plan"))


@pytest.fixture(scope="module")
def port_worlds():
    """Each world's per-rank results, run on first use."""
    done = {}

    def get(world):
        if world not in done:
            cases = WORLDS[world]
            n = int(np.prod(C.PLAN_CASES[cases[0]][3]))
            done[world] = run_spmd(
                C.plan_cases, n,
                args=({c: C.PLAN_CASES[c] for c in cases}, "cpu"),
                device="cpu", timeout_s=TIMEOUT_S)
        return done[world]
    return get


@pytest.mark.parametrize("case", list(C.PLAN_CASES))
def test_mode_and_placements_match_reference(case, reference,
                                             port_worlds):
    ranks = port_worlds(WORLD_OF[case])
    _, meta = reference
    want = meta[case]
    for got in ranks:
        got = got[case]
        assert (got["mode"], got["dp"], got["tp"], got["pp"]) == \
            (want["mode"], want["dp"], want["tp"], want["pp"])
        assert got["placements"] == want["placements"]
        assert got["primitives"] == want["primitives"]


@pytest.mark.parametrize("case", list(C.PLAN_CASES))
def test_outputs_match_reference_mesh_executable(case, reference,
                                                 port_worlds):
    ranks = port_worlds(WORLD_OF[case])
    outs, _ = reference
    ref = {k.split("/", 1)[1]: v for k, v in outs.items()
           if k.startswith(case + "/")}
    assert ref
    for got in ranks:
        got = got[case]["mesh"]
        for k, v in ref.items():
            assert C.rel_dist(got[k], v) <= REF_REL, k


@pytest.mark.parametrize("case", list(C.PLAN_CASES))
def test_outputs_match_own_single_device_plan(case, port_worlds):
    ranks = port_worlds(WORLD_OF[case])
    first = ranks[0][case]["mesh"]
    for got in ranks:
        got = got[case]
        assert got["on"] == "cpu" and got["dtype"] == "torch.float32"
        assert set(got["mesh"]) == set(got["plain"])
        for k, v in got["mesh"].items():
            assert v.shape[0] == C.BATCH, k       # the full batch
            assert C.rel_dist(v, got["plain"][k]) <= SELF_REL, k
            np.testing.assert_array_equal(v, first[k])  # every rank


def test_pure_dp_prices_the_same_on_both_batch_meshes(reference):
    """dp shards over ALL non-stage axes: (8,) and (2, 4) price one
    pure-dp plan identically, in both packages."""
    _, meta = reference
    net = t_towers.conv_stack((4, 32, 32), depth=3, width=8).with_batch(8)
    cm = TCost()
    sel_24 = t_select(net, cm, mesh_axes={"data": 2, "model": 4})
    sel_8 = t_select(net, cm, mesh_axes={"data": 8})
    assert sel_24.predicted_cost == sel_8.predicted_cost
    assert all(c.placement == "dp" for c in sel_24.choices.values())
    assert sel_24.predicted_cost == \
        meta["conv_stack_data2_model4"]["predicted"]
    assert sel_8.predicted_cost == meta["conv_stack_data8"]["predicted"]


def test_mesh_entry_points_need_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    from repro_torch.launch.mesh import make_mesh
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((2,), ("data",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_spmd(C.different_plans, 2)


def test_different_plans_raise_instead_of_hanging():
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="compiled different plans"):
        run_spmd(C.different_plans, 2, args=("cpu",), device="cpu",
                 timeout_s=TIMEOUT_S)
    assert time.perf_counter() - t0 < TIMEOUT_S


#: a program that runs a world, calls stop_spmd and exits
_STOP_SCRIPT = """
import sys
sys.path[:0] = [{tests!r}, {src!r}]
import _torch_mesh_cases as C
from repro_torch.launch.mesh import run_spmd, stop_spmd
if __name__ == "__main__":
    out = run_spmd(C.pipe_cases, 1, args=(("s1_m4",), "cpu"), device="cpu",
                   timeout_s=60)
    stop_spmd()
    print(sorted(out[0]))
"""


def _session(sid):
    """The processes of session ``sid`` still alive."""
    import os
    left = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            if os.getsid(int(pid)) == sid:
                left.append(pid)
        except (ProcessLookupError, PermissionError):
            pass
    return left


def test_stop_spmd_leaves_no_process_behind(tmp_path):
    """A program that calls ``stop_spmd`` after its last world leaves no
    process running when it exits: neither the fork server its ranks
    fork from nor the resource tracker (both otherwise outlive it, until
    they read the end of their pipe)."""
    import subprocess
    import sys
    script = tmp_path / "stop_spmd.py"
    script.write_text(_STOP_SCRIPT.format(
        tests=str(C.REPO / "tests"), src=str(C.REPO / "src")))
    log = tmp_path / "out.txt"
    # output to a file: a helper left running would hold a pipe open
    with open(log, "w") as out:
        proc = subprocess.Popen([sys.executable, str(script)], stdout=out,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        rc = proc.wait(timeout=120)
    left = _session(proc.pid)
    assert rc == 0, log.read_text()
    assert log.read_text().split("\n")[-2] == "['s1_m4']"
    assert left == []


# ---------------------------------------------------------------------
# validation: the reference's ValueErrors, no world needed
# ---------------------------------------------------------------------
def _meshes(shape, names):
    """Stand-ins carrying only the axes: the reference's (``axis_names``,
    ``devices``) and the port's (``mesh_dim_names``, ``mesh``)."""
    ref = types.SimpleNamespace(axis_names=tuple(names),
                                devices=np.empty(shape, object))
    port = types.SimpleNamespace(mesh_dim_names=tuple(names),
                                 mesh=torch.arange(int(np.prod(shape)))
                                 .reshape(shape), device_type="cpu")
    return ref, port


def _sel(select, towers, cost, builder, shape, kw, mesh_axes,
         rewrite=None):
    """A solved selection at batch 8, its placements passed through
    ``rewrite(node id, placement, net order)``."""
    net = getattr(towers, builder)(shape, **kw).with_batch(8)
    sel = select(net, cost(), mesh_axes=mesh_axes)
    if rewrite:
        sel = dataclasses.replace(sel, choices={
            k: dataclasses.replace(
                c, placement=rewrite(k, str(c.placement), net.order))
            for k, c in sel.choices.items()})
    return sel, net.init_params(0)


def _no_dp(nid, pl, order):
    return "rep" if pl == "dp" else pl


def _last_leaves_pipeline(nid, pl, order):
    return "rep" if nid == order[-1] else pl


#: (selection: builder, shape, kwargs, mesh axes, placement rewrite),
#: (stand-in mesh shape, names), batch
INVALID = {
    "single_image": (("conv_stack", (4, 16, 16), dict(depth=2, width=8),
                      {"data": 2}, None), ((2,), ("data",)), 1),
    "dp_batch_indivisible": (("conv_stack", (4, 16, 16),
                              dict(depth=2, width=8), {"data": 2}, None),
                             ((4,), ("data",)), 6),
    "tp_without_model_axis": (("bottleneck_tower", (4, 16, 16), {},
                               {"data": 2, "model": 4}, _no_dp),
                              ((2,), ("data",)), 8),
    "tp_batch_not_over_data": (("bottleneck_tower", (4, 16, 16), {},
                                {"data": 2, "model": 4}, _no_dp),
                               ((3, 4), ("data", "model")), 8),
    "tp_channels_indivisible": (("bottleneck_tower", (4, 16, 16), {},
                                 {"data": 2, "model": 4}, _no_dp),
                                ((2, 3), ("data", "model")), 8),
    "pp_without_stage_axis": (("uniform_stack", (8, 8, 8),
                               dict(depth=6), {"stage": 4}, None),
                              ((4,), ("data",)), 8),
    "pp_partial": (("uniform_stack", (8, 8, 8), dict(depth=6),
                    {"stage": 4}, _last_leaves_pipeline),
                   ((4,), ("stage",)), 8),
}


@pytest.mark.parametrize("case", list(INVALID))
def test_invalid_mesh_plans_raise_the_reference_error(case):
    spec, (mshape, names), batch = INVALID[case]
    r_sel, r_par = _sel(r_select, r_towers, RCost, *spec)
    t_sel, t_par = _sel(t_select, t_towers, TCost, *spec)
    r_mesh, t_mesh = _meshes(mshape, names)
    with pytest.raises(ValueError) as r_err:
        RP.compile_plan(r_sel, r_par, batch=batch, mesh=r_mesh)
    with pytest.raises(ValueError) as t_err:
        TP.compile_plan(t_sel, t_par, batch=batch, mesh=t_mesh,
                        device="cpu")
    assert str(t_err.value) == str(r_err.value)


def test_a_mesh_of_another_device_type_is_refused():
    _, t_mesh = _meshes((2,), ("data",))
    t_mesh.device_type = "cuda"
    sel, par = _sel(t_select, t_towers, TCost, "conv_stack", (4, 16, 16),
                    dict(depth=2, width=8), {"data": 2})
    with pytest.raises(ValueError, match="cuda mesh"):
        TP.compile_plan(sel, par, batch=8, mesh=t_mesh, device="cpu")


# ---------------------------------------------------------------------
# the backend: NCCL only where every rank of a node has a card
# ---------------------------------------------------------------------
class _Joined(Exception):
    """Stands in for the process group's rendezvous."""


@pytest.mark.parametrize("env,gpus,backend", [
    ({"WORLD_SIZE": "16", "LOCAL_WORLD_SIZE": "8", "LOCAL_RANK": "5"}, 8,
     "nccl"),                                  # 2 nodes x 8 cards
    ({"WORLD_SIZE": "4", "LOCAL_WORLD_SIZE": "4", "LOCAL_RANK": "3"}, 1,
     "gloo"),                                  # 4 ranks share one card
    ({"WORLD_SIZE": "16", "LOCAL_WORLD_SIZE": "16", "LOCAL_RANK": "9"}, 8,
     "gloo"),                                  # 16 ranks on 8 cards
    ({"WORLD_SIZE": "2", "LOCAL_RANK": "1"}, 2, "nccl"),  # no local size
])
def test_make_mesh_takes_nccl_where_each_rank_of_a_node_has_a_card(
        monkeypatch, env, gpus, backend):
    """``make_mesh`` under ``torchrun``'s environment: the backend follows
    the ranks of this node (``LOCAL_WORLD_SIZE``, else the world) against
    its cards, and the rank takes card ``LOCAL_RANK % cards``."""
    import repro_torch.launch.mesh as M
    seen = []

    def init(b):
        seen.append(b)
        raise _Joined

    monkeypatch.setattr(M, "resolve_device", lambda d: torch.device("cuda"))
    monkeypatch.setattr(M.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(M.dist, "init_process_group", init)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: gpus)
    monkeypatch.setattr(torch.cuda, "set_device", seen.append)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(_Joined):
        M.make_mesh((int(env["WORLD_SIZE"]),), ("data",))
    assert seen == [int(env["LOCAL_RANK"]) % gpus, backend]
    assert M.default_backend("cuda", int(env.get(
        "LOCAL_WORLD_SIZE", env["WORLD_SIZE"]))) == backend
    assert M.default_backend("cpu", 1) == "gloo"
