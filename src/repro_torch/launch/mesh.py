"""Device meshes over ``torch.distributed``, and an SPMD launcher.

Port of the reference's ``launch/mesh.py``.  A mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` whose axes carry the
reference's names (``data``, ``model``, ``stage``); every rank of the
world runs the same program on the same inputs, as ``torchrun`` launches
it, and the mesh-sharded executables of :func:`~repro_torch.core.plan.
compile_plan` issue their collectives over the mesh's process groups.

Two ways to get a world:

* **Under ``torchrun``** (``torchrun --nproc-per-node N script.py``):
  :func:`make_mesh` initialises the default process group from the
  environment ``torchrun`` sets.
* **In-process** (tests, ``chip_smoke.py``): :func:`run_spmd` starts
  ``world`` processes from a fork server; they meet over a file in a
  temporary directory, run a function each and return every rank's
  result.

The backend is explicit.  It defaults to NCCL only where every rank of
a node has a GPU of its own (``LOCAL_WORLD_SIZE`` at most the node's
GPUs); a node of more ranks than GPUs (several ranks sharing ``cuda:0``
on a one-card machine, which NCCL refuses) and a CPU world take gloo,
whose collectives on CUDA tensors pass through the host.

The reference's ``force_host_devices`` (an XLA flag asking for fake CPU
devices) has no counterpart: the world size of :func:`run_spmd` plays
its role, and the dry-run's 256 or 512 ranks are a ``"fake"`` process
group in one process (:mod:`repro_torch.launch.dryrun`), over which
:func:`make_production_mesh` builds the production mesh.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time
import traceback
from queue import Empty
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..core.plan import mesh_shape_dict  # re-export: single definition
from ..kernels.common import resolve_device

__all__ = ["parse_mesh_spec", "mesh_shape_dict", "mesh_fingerprint",
           "make_mesh", "make_production_mesh", "default_backend",
           "stage_collectives_on_host", "run_spmd", "stop_spmd"]

#: CLI parallelism names -> mesh axis names.  The CLI speaks the
#: paper's vocabulary (dp/tp/stage); the mesh speaks the reference's
#: (data/model/stage).
_MESH_AXIS_ALIASES = {"dp": "data", "data": "data",
                      "tp": "model", "model": "model",
                      "pp": "stage", "stage": "stage"}


def parse_mesh_spec(spec: str):
    """Parse ``"dp=2,tp=2,stage=2"`` into ``(shape, axis_names)``.

    Accepts both CLI aliases (dp/tp/pp) and raw axis names
    (data/model/stage), in any order; size-1 axes are dropped (a
    1-wide group is just replication — the solver prices it
    identically, see ``core.costs.send_time``).  Axis order is
    canonicalized to (data, model, stage) so equivalent specs
    fingerprint identically.
    """
    sizes = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"mesh spec entry {part!r} is not "
                             f"<axis>=<size> (spec: {spec!r})")
        name, _, val = part.partition("=")
        axis = _MESH_AXIS_ALIASES.get(name.strip().lower())
        if axis is None:
            raise ValueError(
                f"unknown mesh axis {name.strip()!r} — use "
                f"dp/tp/stage (spec: {spec!r})")
        try:
            size = int(val)
        except ValueError:
            raise ValueError(f"mesh axis {name.strip()!r} has non-"
                             f"integer size {val!r}") from None
        if size < 1:
            raise ValueError(f"mesh axis {name.strip()!r} has size "
                             f"{size} < 1")
        if axis in sizes:
            raise ValueError(f"mesh axis {axis!r} given twice in "
                             f"{spec!r}")
        sizes[axis] = size
    canon = [(a, sizes[a]) for a in ("data", "model", "stage")
             if sizes.get(a, 1) > 1]
    if not canon:
        raise ValueError(f"mesh spec {spec!r} names no axis wider "
                         f"than 1 device")
    return tuple(s for _, s in canon), tuple(a for a, _ in canon)


def mesh_fingerprint(mesh) -> str:
    """Stable cache-key component for a mesh: device type + axis
    topology, e.g. ``cuda-data2`` or ``cpu-data2xmodel2``.

    Ranks are deliberately excluded — the same topology in another world
    solves identical placement PBQPs, so its persisted plans stay valid.
    """
    if mesh is None:
        return "none"
    axes = "x".join(f"{n}{s}" for n, s in mesh_shape_dict(mesh).items())
    return f"{mesh.device_type}-{axes}"


def default_backend(device, local_world: int) -> str:
    """NCCL where each of the ``local_world`` ranks of a node has a GPU
    of its own, else gloo (a CPU world, or ranks sharing a card: NCCL
    refuses two ranks on one device)."""
    dev = torch.device(device)
    if dev.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device=None, *, backend: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` named ``axis_names`` over the world.

    The counterpart of the reference's ``make_mesh_compat`` /
    ``make_cpu_mesh``.  ``device`` is the card unless ``"cpu"`` is asked
    for (without a GPU the default raises).  Outside :func:`run_spmd`
    the default process group is initialised from ``torchrun``'s
    environment with ``backend`` (default: :func:`default_backend` of
    the node's ``LOCAL_WORLD_SIZE`` ranks), and rank ``LOCAL_RANK`` of a
    node takes card ``LOCAL_RANK % device_count()``.  Inside an existing
    world the mesh's groups take the world's backend unless ``backend``
    names another.  Rank 0 prints the backend, and says so where ranks
    share a card.
    """
    dev = resolve_device(device)
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    override = None
    if not dist.is_initialized():
        world = int(os.environ.get("WORLD_SIZE", "0"))
        if world < 1:
            raise RuntimeError(
                "no process group: launch with torchrun or run_spmd")
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                                  % torch.cuda.device_count())
        local = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
        dist.init_process_group(backend or default_backend(dev, local))
    elif backend is not None:
        override = {a: backend for a in axis_names}
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh(dev.type, shape, mesh_dim_names=axis_names,
                            backend_override=override)
    if dev.type == "cuda" and (backend or dist.get_backend()) == "gloo":
        stage_collectives_on_host()
    if dist.get_rank() == 0:
        world, gpus = dist.get_world_size(), torch.cuda.device_count()
        local = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
        shared = dev.type == "cuda" and local > gpus
        print(f"mesh {mesh_fingerprint(mesh)}: backend "
              f"{backend or dist.get_backend()} ({world} ranks, {local} "
              f"on this node, {gpus} GPUs"
              f"{': ranks share cards' if shared else ''})", flush=True)
    return mesh


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 = 256-rank single pod (``data``, ``model``); 2x16x16 =
    512-rank two-pod mesh (``pod``, ``data``, ``model``), over the
    current world, which must have that many ranks (the dry-run's fake
    process group).  ``device``: the mesh's device type, the card unless
    told otherwise."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not dist.is_initialized() or dist.get_world_size() != \
            int(torch.tensor(shape).prod()):
        raise RuntimeError(
            f"the production mesh {shape} needs a world of "
            f"{int(torch.tensor(shape).prod())} ranks (the dry-run's fake "
            f"process group)")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=axes)


def stage_collectives_on_host() -> None:
    """Route DTensor's collectives on CUDA tensors through host copies.

    A gloo group takes CUDA tensors through the host in its ``c10d``
    calls (``dist.all_reduce`` and the like), but the functional
    collectives DTensor issues (``torch.distributed.
    _functional_collectives``, and its shard-dimension all-to-all) reach
    gloo's CUDA path differently and crash the process in the PyTorch
    the card's machine runs.  Installed once per process by
    :func:`make_mesh` for a gloo mesh on CUDA (ranks sharing a card):
    each of those calls gets a host copy of its CUDA operand and its
    result is copied back, which is what gloo does with a CUDA tensor
    anyway.  A CPU tensor is passed on as it is."""
    import torch.distributed._functional_collectives as fc
    from torch.distributed.tensor import _collective_utils, placement_types
    if getattr(fc, "_staged_on_host", False):
        return

    def staged(fn):
        def call(t, *args, **kwargs):
            if not t.is_cuda:
                return fn(t, *args, **kwargs)
            return fn(t.cpu(), *args, **kwargs).to(t.device)
        return call
    for name in ("all_gather_tensor", "all_reduce", "reduce_scatter_tensor",
                 "all_to_all_single", "broadcast"):
        setattr(fc, name, staged(getattr(fc, name)))
    for mod in (_collective_utils, placement_types):
        if hasattr(mod, "shard_dim_alltoall"):
            mod.shard_dim_alltoall = staged(mod.shard_dim_alltoall)
    fc._staged_on_host = True


# ---------------------------------------------------------------------
# the SPMD launcher
# ---------------------------------------------------------------------
def _worker(rank: int, world: int, init: str, backend: str, device: str,
            timeout_s: float, fn: Callable, args: tuple, queue) -> None:
    """One rank: join the world, run ``fn(*args)``, report to the
    parent (the result, or the traceback), leave the world."""
    import faulthandler
    faulthandler.enable()   # a rank that crashes prints where
    try:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, init_method=init, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            queue.put((rank, True, fn(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))


def run_spmd(fn: Callable, world: int, *, args: tuple = (), device=None,
             timeout_s: float = 60.0) -> List[Any]:
    """Run ``fn(*args)`` on every rank of a new ``world``-process world.

    Each rank is a process forked from a fork server that imported
    ``torch`` and ``__main__`` once (``fn`` and ``args`` are pickled, so
    ``fn`` is a module-level function, and a script guards its entry
    with ``if __name__ == "__main__":``) that joins the default process
    group through a file in a temporary directory, with the
    :func:`default_backend` of ``device`` (the card unless ``"cpu"`` is
    asked for; all ``world`` ranks are on this node) and a collective
    timeout of ``timeout_s``:
    a collective that the other ranks never join fails there instead of
    hanging.  Returns the ranks' results in rank order.  The first rank
    to fail ends the world: the others are terminated and a
    ``RuntimeError`` carries the failing rank's traceback; so does a
    rank that dies without a word.
    """
    import multiprocessing as mp
    dev = resolve_device(device)
    backend = default_backend(dev, world)
    # a fork server that has imported torch and this module (and never
    # touched CUDA) forks the ranks: each starts without importing
    # torch anew, which a spawned interpreter pays for in CPU seconds
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(["__main__", "torch", __name__])
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="spmd") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_worker, daemon=True,
                             args=(r, world, init, backend, str(dev),
                                   timeout_s, fn, args, queue))
                 for r in range(world)]
        for p in procs:
            p.start()
        results: Dict[int, Any] = {}
        try:
            while len(results) < world:
                try:
                    rank, ok, payload = queue.get(timeout=1.0)
                except Empty:  # look for ranks that died silently
                    dead = [r for r, p in enumerate(procs)
                            if r not in results and not p.is_alive()
                            and p.exitcode not in (0, None)]
                    if dead:
                        # a report may still be in flight in the pipe
                        time.sleep(0.5)
                        if queue.empty():
                            raise RuntimeError(
                                f"rank {dead[0]} of {world} died with exit "
                                f"code {procs[dead[0]].exitcode} and no "
                                f"report") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                       f"{payload}")
                results[rank] = payload
        finally:
            for p in procs:
                p.join(timeout=10.0 if len(results) == world else 0.0)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5.0)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [results[r] for r in range(world)]


def stop_spmd() -> None:
    """Stop the helper processes that :func:`run_spmd` leaves running:
    the fork server its ranks fork from, and ``multiprocessing``'s
    resource tracker.  Waits for both to exit.

    Left alone, each exits only after the program does, when it reads
    the end of a pipe that the program's exit closes: a program that
    must leave no process behind calls this after its last world (every
    rank has exited by then).  A later :func:`run_spmd` starts them
    anew.  ``multiprocessing`` offers no public call for this; the
    private ``_stop`` methods close each helper's pipe and wait for it.
    """
    from multiprocessing import forkserver, resource_tracker
    forkserver._forkserver._stop()  # first: it holds the tracker's pipe
    resource_tracker._resource_tracker._stop()
