"""The mesh cases of the port's parity tests, shared by
``tests/test_torch_mesh_plan.py``, ``tests/test_torch_pipeline_parallel.py``
and ``tests/test_torch_mesh_server.py``.

Two sides run the same cases on the same numpy inputs:

* the port's side: module-level functions that ``run_spmd`` runs on
  every rank of a gloo world (they are pickled by name, so this module
  imports neither ``jax`` nor ``repro``): CPU processes in the CPU
  tests, ranks sharing ``cuda:0`` in ``tests/test_torch_card.py``'s
  ``TestMesh`` and ``chip_smoke.py``'s phase 14, which both run the
  card cases and hold them with :func:`check_card_case`,
  :func:`collectives` and :func:`check_serve`;
* the reference's side: :func:`reference`, which runs a script of
  :data:`REF_SCRIPTS` in one subprocess with
  ``--xla_force_host_platform_device_count=8`` (as
  ``tests/test_distributed.py::run_with_devices`` does) and reads back
  one ``.npz`` of outputs and a JSON of modes and placements.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
BATCH = 8

#: the reference's mesh-plan cases (tests/test_distributed.py,
#: TestShardedPlan and TestFullParallelismPlans): name -> (tower
#: builder, input shape, builder kwargs, mesh shape, axis names)
PLAN_CASES = {
    "conv_stack_data8": ("conv_stack", (4, 32, 32),
                         dict(depth=3, width=8), (8,), ("data",)),
    "conv_tower_data8": ("conv_tower", (4, 32, 32),
                         dict(depth=3, width=8), (8,), ("data",)),
    "bottleneck_data2_model4": ("bottleneck_tower", (4, 16, 16), {},
                                (2, 4), ("data", "model")),
    "conv_stack_data2_model4": ("conv_stack", (4, 32, 32),
                                dict(depth=3, width=8), (2, 4),
                                ("data", "model")),
    "uniform_stack_stage4": ("uniform_stack", (8, 8, 8), dict(depth=6),
                             (4,), ("stage",)),
}

#: the four modes on the card (phase 14's meshes, at most 4 ranks
#: sharing one card): name -> a PLAN_CASES entry, and the mode each gives
CARD_CASES = {
    "conv_stack_data2": ("conv_stack", (4, 32, 32), dict(depth=3, width=8),
                         (2,), ("data",)),
    "conv_tower_data2": ("conv_tower", (4, 32, 32), dict(depth=3, width=8),
                         (2,), ("data",)),
    "bottleneck_data2_model2": ("bottleneck_tower", (4, 16, 16), {},
                                (2, 2), ("data", "model")),
    "uniform_stack_stage4": PLAN_CASES["uniform_stack_stage4"],
}
CARD_MODES = {"conv_stack_data2": "shard_map", "conv_tower_data2": "gspmd",
              "bottleneck_data2_model2": "tp_shard_map",
              "uniform_stack_stage4": "pipeline"}

#: the pipeline cases: name -> (stages, n_micro, microbatch, width,
#: input seed); stage_fn(p, x) = tanh(x @ p["w"])
PIPE_CASES = {"s4_m8": (4, 8, 2, 16, 0), "s1_m4": (1, 4, 2, 8, 0),
              "s4_m1": (4, 1, 3, 8, 1)}

#: the mesh server's request stream (tests/test_distributed.py,
#: TestShardedPlan::test_mesh_plan_server_matches_plain)
SERVER_MESH = ((8,), ("data",))
SERVER_POLICY = dict(min_hw=8, max_hw=64)
SERVER_TOWER = dict(depth=2, width=8)


def plan_input(shape) -> np.ndarray:
    return np.random.default_rng(0).normal(
        size=(BATCH,) + tuple(shape)).astype(np.float32)


def pipe_operands(case):
    s, n_micro, mb, d, seed = PIPE_CASES[case]
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(s, d, d)) * 0.3).astype(np.float32)
    x = rng.normal(size=(n_micro, mb, d)).astype(np.float32)
    return w, x


#: the stream's H and W: the reference's range (one bucket, 16 x 16)
SERVER_HW = (12, 17)


def server_stream(hw=SERVER_HW):
    """16 images whose H and W are drawn from ``hw``."""
    rng = np.random.default_rng(0)
    return [rng.normal(size=(4, int(rng.integers(*hw)),
                             int(rng.integers(*hw)))).astype(np.float32)
            for _ in range(16)]


# ---------------------------------------------------------------------
# the port's side: each function runs on every rank of a world
# ---------------------------------------------------------------------
def taps(net):
    """Every conv and every sink: the outputs a port plan returns."""
    return [n.id for n in net.conv_nodes()] + [
        o for o in net.outputs() if net.nodes[o].kind != "conv"]


def launches_of(sel, cn, mesh):
    """This rank's launches in one forward of the mesh executable ``cn``
    of ``sel`` on the card: one per kernel conv, and two Winograd
    transforms per 2-D Winograd conv, a pipeline stage's once per
    microbatch and only its own."""
    from repro_torch.core.plan import mesh_shape_dict
    from repro_torch.core.selection import Placement, pp_microbatches
    from repro_torch.kernels import conv_launches
    stages = mesh_shape_dict(mesh).get("stage", 1)
    reps = pp_microbatches(cn.batch, stages) if cn.pp_nodes else 1
    me = mesh.get_local_rank("stage") if cn.pp_nodes else 0
    want = {}
    for node in sel.net.conv_nodes():
        ch = sel.choices[node.id]
        if Placement.parse(ch.placement).stage != me:
            continue
        for k, n in conv_launches(ch.primitive.name).items():
            want[k] = want.get(k, 0) + n * reps
    return want


def plan_cases(cases, device="cpu"):
    """Each case of ``cases`` (name -> a :data:`PLAN_CASES` entry, all on
    one mesh): the port's selection on the case's mesh axes, compiled
    mesh-sharded (``jit=True``, which a mesh accepts and ignores) and
    compiled without a mesh (the same selection, eager), both run on the
    case's input; on the card also the same selection compiled for the
    CPU, where every wrapper runs its plain version.  The mesh forward
    is a path named ``mesh_<mode>_<case>``: this rank's launch counts at
    0 just before and read just after, beside the launches it must make
    (:func:`launches_of`; none on the CPU).  Returns {case: {mode,
    counts, placements, primitives, path, launches, want, mesh outputs,
    plain outputs, host outputs, whether a graph was captured}} as
    numpy."""
    import torch

    from repro_torch.core.costs import AnalyticCostModel
    from repro_torch.core.plan import compile_plan
    from repro_torch.core.selection import select_pbqp
    from repro_torch.kernels.common import (launch_counts,
                                            reset_launch_counts)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving import towers

    def host(outs):
        return {k: v.detach().cpu().numpy() for k, v in outs.items()}

    res = {}
    mesh = None
    on_card = torch.device(device).type == "cuda"
    for name, (builder, shape, kw, mshape, axes) in cases.items():
        if mesh is None:
            mesh = make_mesh(mshape, axes, device)
        net = getattr(towers, builder)(shape, **kw).with_batch(BATCH)
        sel = select_pbqp(net, AnalyticCostModel(),
                          mesh_axes=dict(zip(axes, mshape)))
        params = net.init_params(0)
        x = plan_input(shape)
        outs = taps(net)
        cn = compile_plan(sel, params, batch=BATCH, mesh=mesh,
                          device=device, outputs=outs)
        cn0 = compile_plan(sel, params, batch=BATCH, device=device,
                           jit=False, outputs=outs)
        xt = torch.from_numpy(x).to(cn.device)
        cn.synchronize()
        reset_launch_counts()
        got = cn(xt)
        cn.synchronize()
        launches = launch_counts()
        want = cn0(xt)
        res[name] = {
            "mode": cn.mesh_mode, "dp": cn.dp_nodes, "tp": cn.tp_nodes,
            "pp": cn.pp_nodes, "captured": cn.graph is not None,
            "path": f"mesh_{cn.mesh_mode}_{name}", "launches": launches,
            "want": launches_of(sel, cn, mesh) if on_card else {},
            "placements": {k: str(c.placement)
                           for k, c in sel.choices.items()},
            "primitives": {k: c.primitive.name
                           for k, c in sel.choices.items()
                           if c.primitive is not None},
            "mesh": host(got), "plain": host(want),
            "host": host(compile_plan(sel, params, batch=BATCH,
                                      device="cpu", outputs=outs)(x))
            if on_card else None,
            "dtype": str(next(iter(got.values())).dtype),
            "on": str(next(iter(got.values())).device.type),
        }
    return res


def check_card_case(name, got, rel, device="cuda"):
    """One rank's result of card case ``name`` (from :func:`plan_cases`
    on ``device``): the case's mode, nothing captured, the path's
    launches as expected, and every output within ``rel`` of the largest
    magnitude of the same selection without a mesh, on ``device`` and,
    from the card, on the CPU (the plain versions)."""
    assert (got["mode"], got["on"]) == (CARD_MODES[name], device), \
        (name, got["mode"], got["on"])
    assert not got["captured"], f"{name}: a mesh executable was captured"
    assert got["launches"] == got["want"], \
        f"path {got['path']}: launches {got['launches']}, expected " \
        f"{got['want']}"
    for ref in ("plain", "host") if device == "cuda" else ("plain",):
        assert set(got["mesh"]) == set(got[ref]), (name, ref)
        for k, v in got["mesh"].items():
            d = rel_dist(v, got[ref][k])
            assert d <= rel, f"{name} {k} vs the {ref} plan: {d:.3e}"


def different_plans(device="cpu"):
    """Rank 1 compiles the SUM2D plan, the others the PBQP plan."""
    import torch.distributed as dist

    from repro_torch.core.costs import AnalyticCostModel
    from repro_torch.core.plan import compile_plan
    from repro_torch.core.selection import select_pbqp, select_sum2d
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving import towers

    mesh = make_mesh((dist.get_world_size(),), ("data",), device)
    net = towers.conv_stack((4, 16, 16), depth=2, width=8).with_batch(4)
    cm = AnalyticCostModel()
    sel = select_sum2d(net, cm) if dist.get_rank() == 1 else \
        select_pbqp(net, cm, mesh_axes={"data": dist.get_world_size()})
    compile_plan(sel, net.init_params(0), batch=4, mesh=mesh,
                 device=device)
    return "compiled"


def pipe_cases(names, device="cpu"):
    """``pipeline_apply`` on each case of ``names`` (all with the same
    stage count) over a ``stage`` mesh of the world."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import pipeline_apply

    mesh = make_mesh((dist.get_world_size(),), ("stage",), device)
    res = {}
    for name in names:
        s, n_micro = PIPE_CASES[name][:2]
        w, x = pipe_operands(name)
        y = pipeline_apply(
            mesh, lambda p, xm: torch.tanh(xm @ p["w"]),
            {"w": torch.from_numpy(w).to(device)},
            torch.from_numpy(x).to(device), n_micro=n_micro)
        res[name] = y.cpu().numpy()
    return res


def collectives(device="cuda"):
    """Each collective a mesh executable or server issues, on ``device``
    tensors over the whole world, held to its expected values on this
    rank: the tiled all-gather (``dist.all_gather`` of equal chunks),
    all-gather into one tensor, all-reduce, the pipeline's rotation
    (``all_to_all_single`` with uneven splits) and final broadcast
    (through ``pipeline_apply`` with a stage function that adds 1), the
    object all-gather of the plan check, and the barrier.  Returns the
    collectives' names and the device types their results lay on."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import pipeline_apply

    r, w = dist.get_rank(), dist.get_world_size()
    ranks = [float(i) for i in range(w)]
    t = torch.full((2, 3), float(r), device=device)
    chunks = [torch.empty_like(t) for _ in range(w)]
    dist.all_gather(chunks, t)
    assert [c[1, 2].item() for c in chunks] == ranks, \
        f"all_gather: {[c.tolist() for c in chunks]}"
    out = torch.empty((2 * w, 3), device=device)
    dist.all_gather_into_tensor(out, t)
    assert out[::2, 0].tolist() == ranks, \
        f"all_gather_into_tensor: {out.tolist()}"
    x = torch.full((5,), float(r + 1), device=device)
    dist.all_reduce(x)
    assert x.tolist() == [float(w * (w + 1) // 2)] * 5, \
        f"all_reduce: {x.tolist()}"
    mesh = make_mesh((w,), ("stage",), device)
    xs = torch.arange(24, dtype=torch.float32,
                      device=device).reshape(3, 2, 4)
    y = pipeline_apply(mesh, lambda p, v: v + 1, {}, xs, n_micro=3)
    assert bool(y.equal(xs + w)), \
        f"pipeline_apply's rotation and broadcast: {y.tolist()}"
    objs = [None] * w
    dist.all_gather_object(objs, f"rank{r}")
    assert objs == [f"rank{i}" for i in range(w)], objs
    dist.barrier()
    return {"names": ["all_gather", "all_gather_into_tensor", "all_reduce",
                      "all_to_all_single", "broadcast",
                      "all_gather_object", "barrier"],
            "devices": sorted({str(v.device.type)
                               for v in (*chunks, out, x, y)})}


def serve_cases(cache_dir, device="cpu", mesh_spec=SERVER_MESH,
                hw=SERVER_HW):
    """The mesh server against the meshless one on one stream (H and W
    from ``hw``), then a mesh server's plan written to ``cache_dir`` and
    read back by a fresh one."""
    from repro_torch.core.costs import AnalyticCostModel
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving import BucketPolicy, PlanServer, conv_stack

    mesh = make_mesh(*mesh_spec, device)
    policy = BucketPolicy(**SERVER_POLICY)

    def build(s):
        return conv_stack(s, **SERVER_TOWER)

    stream = server_stream(hw)
    srv_m = PlanServer(build, AnalyticCostModel(), policy=policy,
                       mesh=mesh, device=device)
    srv_0 = PlanServer(build, AnalyticCostModel(), policy=policy,
                       device=device)
    res = {"versions": (srv_m.cost_version, srv_0.cost_version),
           "mesh": srv_m.infer_batch(stream),
           "plain": srv_0.infer_batch(stream),
           "one_mesh": srv_m.infer(stream[0]),
           "one_plain": srv_0.infer(stream[0]),
           "stats": {k: v for k, v in srv_m.stats().items()
                     if isinstance(v, (int, float))}}
    srv_m.close()
    srv_0.close()
    xs = [np.ones((4, 16, 16), np.float32)] * 8
    srv = PlanServer(build, AnalyticCostModel(), policy=policy, mesh=mesh,
                     cache_dir=cache_dir, device=device)
    res["disk1"] = srv.infer_batch(xs)[0]
    res["disk1_solves"] = srv.stats()["solves"]
    srv.close()
    srv2 = PlanServer(build, AnalyticCostModel(), policy=policy, mesh=mesh,
                      cache_dir=cache_dir, device=device)
    res["disk2"] = srv2.infer_batch(xs)[0]
    res["disk2_stats"] = {k: v for k, v in srv2.stats().items()
                          if isinstance(v, (int, float))}
    srv2.close()
    return res


def check_serve(r, rel):
    """One rank's :func:`serve_cases` result: every answer, the batch-1
    one too, within ``rel`` of the meshless server's largest magnitude;
    at least one executable compiled mesh-sharded; the second server on
    the cache directory solved nothing.  Returns the distance."""
    scale = max(float(np.abs(v).max()) for o in r["plain"]
                for v in o.values())
    err = 0.0
    for got, want in zip(r["mesh"] + [r["one_mesh"]],
                         r["plain"] + [r["one_plain"]]):
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape, (k, got[k].shape)
            err = max(err, float(np.abs(got[k] - want[k]).max()))
    assert err <= rel * scale, f"mesh server: {err:.3e} > {rel} x {scale:.3e}"
    assert r["stats"]["mesh_compiles"] >= 1, r["stats"]
    assert r["disk2_stats"]["solves"] == 0, r["disk2_stats"]
    return err / scale


# ---------------------------------------------------------------------
# the reference's side: one subprocess per test file
# ---------------------------------------------------------------------
_REF_HEAD = """
import json, sys
import numpy as np
import _torch_mesh_cases as C
from repro.launch.mesh import make_mesh_compat
out, meta = {}, {}
"""

REF_SCRIPTS = {
    "plan": """
from repro.core.costs import AnalyticCostModel
from repro.core.plan import compile_plan
from repro.core.selection import select_pbqp
from repro.serving import towers
cm = AnalyticCostModel()
for name, (builder, shape, kw, mshape, axes) in C.PLAN_CASES.items():
    mesh = make_mesh_compat(mshape, axes)
    net = getattr(towers, builder)(shape, **kw).with_batch(C.BATCH)
    sel = select_pbqp(net, cm, mesh_axes=dict(zip(axes, mshape)))
    cn = compile_plan(sel, net.init_params(0), batch=C.BATCH, mesh=mesh)
    for k, v in cn(C.plan_input(shape)).items():
        out[name + '/' + k] = np.asarray(v)
    meta[name] = dict(
        mode=cn.mesh_mode, dp=cn.dp_nodes, tp=cn.tp_nodes, pp=cn.pp_nodes,
        predicted=sel.predicted_cost,
        placements={k: c.placement for k, c in sel.choices.items()},
        primitives={k: c.primitive.name for k, c in sel.choices.items()
                    if c.primitive is not None})
""",
    "pipe": """
import jax.numpy as jnp
from repro.runtime import pipeline_apply
for name, (s, n_micro, mb, d, seed) in C.PIPE_CASES.items():
    w, x = C.pipe_operands(name)
    mesh = make_mesh_compat((s,), ('stage',))
    y = pipeline_apply(mesh, lambda p, xm: jnp.tanh(xm @ p['w']),
                       {'w': jnp.asarray(w)}, jnp.asarray(x),
                       n_micro=n_micro)
    out[name] = np.asarray(y)
""",
    "server": """
from repro.core.costs import AnalyticCostModel
from repro.serving import BucketPolicy, PlanServer, conv_stack
mesh = make_mesh_compat(*C.SERVER_MESH)
srv = PlanServer(lambda s: conv_stack(s, **C.SERVER_TOWER),
                 AnalyticCostModel(), policy=BucketPolicy(**C.SERVER_POLICY),
                 mesh=mesh)
for i, o in enumerate(srv.infer_batch(C.server_stream())):
    for k, v in o.items():
        out[f'{i}/{k}'] = np.asarray(v)
meta['mesh_compiles'] = int(srv.stats()['mesh_compiles'])
srv.close()
""",
}


def reference(kind: str, out_dir: pathlib.Path, timeout: int = 600):
    """Run the reference's cases of ``kind`` in one subprocess on 8 fake
    CPU devices; returns ``(outputs, meta)``."""
    path = out_dir / f"ref_{kind}"
    code = _REF_HEAD + REF_SCRIPTS[kind] + textwrap.dedent(f"""
        np.savez({str(path) + '.npz'!r}, **out)
        with open({str(path) + '.json'!r}, 'w') as f:
            json.dump(meta, f)
        """)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO / "src"), str(REPO / "tests")])
    proc = subprocess.run([sys.executable, "-c", code],
                          capture_output=True, text=True, timeout=timeout,
                          env=env)
    assert proc.returncode == 0, \
        f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr[-3000:]}"
    with np.load(str(path) + ".npz") as z:
        outs = {k: z[k] for k in z.files}
    with open(str(path) + ".json") as f:
        meta = json.load(f)
    return outs, meta


def rel_dist(got, want) -> float:
    """Largest difference over the largest magnitude of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
