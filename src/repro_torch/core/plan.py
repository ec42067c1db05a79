"""Execution of an instantiated DNN on PyTorch: the paper's "simple code
generator which emitted calls to primitive operations".

Port of the single-device part of the reference's ``core/plan.py``.  The
executable walks the DAG in topological order, calling the selected
primitive per conv layer, the op function per op node and the explicit
layout-conversion chains the legalizer inserted on illegal edges.  A
batch is a leading axis written out through every primitive and kernel
instead of a ``vmap``, and eager calls never fuse across layers, so
there is no optimization barrier to place.

The reference stages the whole walk as one ``jax.jit`` executable.  Its
counterpart here is a CUDA graph: ``compile_plan(jit=True)`` on a card
captures the forward on its first call (:class:`CapturedForward`) and
replays it after, so one launch replaces the host's dispatch of every
operator.  ``jit=False`` is the eager walk, whose per-layer costs add up
as in the paper.

With ``mesh=`` (a ``DeviceMesh``, :func:`~repro_torch.launch.mesh.
make_mesh`) the generator emits a *mesh-sharded* executable realizing
every node's solved device placement (the ``Choice.placement`` axis of
``select_pbqp(..., mesh_axes=...)``) in SPMD form: every rank runs it on
the full batch and gets the full outputs, so it is a drop-in for the
single-device batched executable.  One lowering per placement family,
with the reference's mode names:

* ``"shard_map"`` — every node ``dp``: split the batch once over the
  mesh's batch axes (``data`` x ``model``, flattened), walk the shard,
  all-gather the outputs.
* ``"gspmd"`` / ``"tp_shard_map"`` — mixed placements: an explicit
  walker whose form changes are the collectives the PBQP edges priced
  (``dp -> rep``: an all-gather; ``rep -> dp``: a local slice); ``tp``
  convs run on the rank's output-channel weight shard and all-gather
  the channel axis over ``model``.
* ``"pipeline"`` — contiguous stage runs lower onto
  :func:`~repro_torch.runtime.pipeline_parallel.pipeline_apply` (GPipe
  fill-drain over the ``stage`` axis), stage boundaries in logical CHW.

Mesh executables run the eager walk: a collective cannot be captured in
a CUDA graph (see :func:`compile_plan`).
"""
from __future__ import annotations

import gc
import hashlib
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import expected_launches
from ..kernels.common import (add_launches, recording_launches,
                              resolve_device, true_f32)
from ..obs.metrics import default_registry
from ..obs.spans import span
from ..obs.trace import get_tracer
from .graph import Net
from .layouts import LAYOUT_BY_NAME
from .primitives import convert_layout
from .selection import Placement, SelectionResult, pp_microbatches

__all__ = ["compile_plan", "CompiledNet", "CapturedForward", "measure",
           "compile_count", "params_from_numpy", "mesh_shape_dict",
           "layout_copies"]

#: bytes of an activation element: every executable computes in float32
F32_BYTES = 4


def mesh_shape_dict(mesh) -> Dict[str, int]:
    """Axis name -> size for a ``DeviceMesh``.  Single definition —
    ``launch.mesh`` re-exports it for CLI-side callers."""
    return {n: int(s) for n, s in zip(mesh.mesh_dim_names,
                                      mesh.mesh.shape)}

#: process-wide count of compile_plan() calls (the obs registry's locked
#: counter, as in the reference)
_COMPILE_COUNTER = default_registry().counter("compile_plan_calls")


def compile_count() -> int:
    return _COMPILE_COUNTER.value


def _host_tensor(a) -> torch.Tensor:
    """``a`` as a tensor where it lies (a numpy array's memory, shared)."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


def _tensor(a, device: torch.device) -> torch.Tensor:
    return _host_tensor(a).to(device)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def params_from_numpy(raw_params: Dict[str, Dict[str, np.ndarray]],
                      device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """The reference's ``Net.init_params(seed)`` dict of numpy arrays as
    the port's raw parameters: the same values, as tensors on ``device``
    (the card unless told otherwise)."""
    dev = resolve_device(device)
    return {nid: {k: _tensor(v, dev) for k, v in p.items()}
            for nid, p in raw_params.items()}


#: one capture at a time in the process, held by whoever builds a
#: :class:`CapturedForward`: a capture must see no other thread's
_CAPTURE_LOCK = threading.Lock()


class _Slot:
    """One staging slot of a graph's copy in: a page-locked host tensor
    and a device tensor shaped like the static input, and two events.
    ``copied`` is recorded on the copy stream after the host-to-device
    copy: the host waits for it before it fills ``pinned`` again, the
    graph's stream before it reads ``device``.  ``consumed`` is recorded
    on the graph's stream after ``device`` was copied into the static
    input: the copy stream waits for it before it writes ``device``
    again.  ``lock`` is held from the fill until both are recorded."""

    __slots__ = ("lock", "pinned", "device", "copied", "consumed")

    def __init__(self, like: torch.Tensor, copy_stream) -> None:
        self.lock = threading.Lock()
        self.pinned = torch.empty(like.shape, dtype=like.dtype,
                                  pin_memory=True)
        self.device = torch.empty_like(like)
        # written on the copy stream: its memory is not reused before
        # that stream's last copy into it has run
        self.device.record_stream(copy_stream)
        self.copied = torch.cuda.Event()
        self.consumed = torch.cuda.Event()


class CapturedForward:
    """One executable's forward as a CUDA graph, and the streams it runs on.

    Built on the executable's first call (``compile_plan(jit=True)`` on a
    card): one eager forward on the graph's own side stream, which does
    the host's one-time work (building and loading the kernel libraries,
    uploading the Winograd transform matrices, the kernels' shared-memory
    attributes, cuBLAS's workspace), then the capture of a second forward
    into a static input and static outputs (``forward`` runs in
    ``true_f32``, so the captured cuBLAS and cuDNN calls keep TF32 off).
    Its constructor runs under ``_CAPTURE_LOCK``, and the capture runs with
    ``capture_error_mode="thread_local"``, so a server's worker can
    capture while the caller replays another executable.  A capture that
    fails raises: nothing runs eagerly in its place.

    :meth:`run` copies the input into the static buffer (span
    ``copy_in``), then replays the graph, clones the static outputs (a
    later call does not overwrite them) and orders the caller's stream
    after (span ``replay``, host enqueue time).  A device tensor, and a
    host input (a numpy array or a CPU tensor) that finds the graph's
    stream idle under its lock, are copied on the graph's stream, after
    the caller's: nothing runs there for the copy to overlap.  A host
    input that finds the previous replay still running, or the lock held
    by a call about to replay, is staged: the next of two
    :class:`_Slot` s, round-robin, is filled on the host (torch's copy,
    on its intra-op threads) and copied to the device on the
    executable's copy stream, and the graph's stream then copies it into
    the static input (device to device) before the replay.  So that
    call's host-to-device copy runs under the other call's replay: the
    host waits for no replay, only for a slot's previous host-to-device
    copy and for the lock over the graph stream's enqueue.  A host input's ``copy_in`` span carries
    ``overlapped``: 1 when the graph's stream still ran the previous
    replay as the host-to-device copy was issued; a staged one carries
    ``staged=1`` too.  ``staged`` and ``overlapped`` count them.

    The launch counts see the warm-up's launches and each replay's, never
    the capture's: a capture records kernels and launches none.  The
    graph reads the executable's packed parameters, and its static input,
    at the addresses they had at capture.
    """

    def __init__(self, forward: Callable, x: torch.Tensor,
                 device: torch.device) -> None:
        self.stream = torch.cuda.Stream(device)
        self.copy_stream = torch.cuda.Stream(device)
        self.graph = torch.cuda.CUDAGraph()
        self._lock = threading.Lock()
        self.stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(self.stream):
            self.static_in = torch.empty(x.shape, dtype=x.dtype,
                                         device=device)
            self.static_in.copy_(x)
            forward(self.static_in)
        # no automatic garbage collection while capturing: one on this
        # thread could free another executable's graph (a dropped
        # executable in a reference cycle), and destroying a graph
        # mid-capture invalidates the capture.  ``torch.cuda.graph``
        # collects before it begins.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with recording_launches() as rec:
                with torch.cuda.graph(self.graph, stream=self.stream,
                                      capture_error_mode="thread_local"):
                    self.static_out = forward(self.static_in)
        finally:
            if collecting:
                gc.enable()
        with torch.cuda.stream(self.stream):
            self._slots = [_Slot(self.static_in, self.copy_stream)
                           for _ in range(2)]
        self._turn = itertools.count()
        #: kernel launches the capture recorded, which it did not count:
        #: each replay launches them, and :meth:`run` counts them there
        self.launches: Dict[str, int] = dict(rec)
        #: replays so far
        self.replays = 0
        #: host inputs staged through the slots, and those of them whose
        #: host-to-device copy was issued while a replay still ran
        self.staged = 0
        self.overlapped = 0

    def run(self, x) -> Dict[str, torch.Tensor]:
        """One replay on ``x``, a tensor or a numpy array."""
        if tuple(x.shape) != tuple(self.static_in.shape):
            raise ValueError(f"the graph was captured for input "
                             f"{tuple(self.static_in.shape)}, got "
                             f"{tuple(x.shape)}")
        caller = torch.cuda.current_stream(self.static_in.device)
        host = not (isinstance(x, torch.Tensor) and x.is_cuda)
        out = None
        # only the lock's holder enqueues a replay: a graph stream found
        # idle under it stays idle until this call's own replay, and a
        # lock held elsewhere is a replay on its way
        if self._lock.acquire(blocking=not host):
            try:
                if not host:
                    out = self._run_direct(x, caller)
                elif self.stream.query():
                    out = self._run_direct(x, caller, overlapped=0)
            finally:
                self._lock.release()
        if out is None:
            out = self._run_staged(x, caller)
        if not host:
            x.record_stream(self.stream)
        for v in out.values():
            v.record_stream(caller)
        return out

    def _run_direct(self, x, caller, **attrs) -> Dict[str, torch.Tensor]:
        """The copy into the static input on the graph's stream, then the
        replay; under the lock, which the caller holds."""
        with torch.cuda.stream(self.stream):
            with span("copy_in", **attrs):
                self.stream.wait_stream(caller)
                self.static_in.copy_(_host_tensor(x))
            return self._replay(caller)

    def _run_staged(self, x, caller) -> Dict[str, torch.Tensor]:
        slot = self._slots[next(self._turn) % len(self._slots)]
        with slot.lock:
            with span("copy_in", staged=1) as sp:
                slot.copied.synchronize()
                slot.pinned.copy_(_host_tensor(x))
                overlapped = not self.stream.query()
                with torch.cuda.stream(self.copy_stream):
                    self.copy_stream.wait_event(slot.consumed)
                    slot.device.copy_(slot.pinned, non_blocking=True)
                    slot.copied.record(self.copy_stream)
                sp.set(overlapped=int(overlapped))
            with self._lock, torch.cuda.stream(self.stream):
                self.stream.wait_stream(caller)
                self.stream.wait_event(slot.copied)
                self.static_in.copy_(slot.device)
                slot.consumed.record(self.stream)
                self.staged += 1
                self.overlapped += overlapped
                return self._replay(caller)

    def _replay(self, caller) -> Dict[str, torch.Tensor]:
        """The replay, its clones and the caller's stream ordered after
        them (span ``replay``); under the lock, on the graph's stream."""
        with span("replay"):
            self.graph.replay()
            out = {k: v.clone() for k, v in self.static_out.items()}
            self.replays += 1
            add_launches(self.launches)
            caller.wait_stream(self.stream)
        return out


@dataclass
class CompiledNet:
    sel: SelectionResult
    fn: Callable                      # (x, params) -> outputs dict
    params: Dict[str, Any]            # packed per-node parameters
    device: torch.device
    build_s: float = 0.0              # wall time of weight packing + wiring
    #: minibatch the executable was compiled for: 1 -> (C, H, W) in/out,
    #: > 1 -> (N, C, H, W) in and a leading N axis on every output
    batch: int = 1
    #: edges executed as fused prologues/epilogues instead of
    #: materialized convert_layout calls
    fused_edges: int = 0
    #: per-conv-node maker callables (fusion-resolved wire layouts)
    makers: Optional[Dict[str, Callable]] = None
    #: the returned nodes and the layout each is produced in (converted
    #: to logical CHW on the way out)
    out_layouts: Optional[Dict[str, str]] = None
    #: capture the forward as a CUDA graph on the first call (a card only)
    jit: bool = False
    #: the graph, once captured
    graph: Optional[CapturedForward] = None
    #: mesh the executable is sharded over (None: single device)
    mesh: Optional[Any] = None
    #: nodes realized batch-sharded over the mesh's batch axes
    dp_nodes: int = 0
    #: "shard_map" (all-dp fast path) | "gspmd" (mixed dp/rep walker)
    #: | "tp_shard_map" (explicit-collective tp walker) | "pipeline"
    #: (GPipe stage schedule) | "" (no mesh)
    mesh_mode: str = ""
    #: nodes realized weight-sharded over the mesh's model axis
    tp_nodes: int = 0
    #: nodes realized as pipeline stages over the mesh's stage axis
    pp_nodes: int = 0
    #: one forward's copies outside the convs (:func:`layout_copies`):
    #: concat nodes and the bytes they read and write, non-identity
    #: layout conversion steps and the bytes they read and write
    joins: int = 0
    join_bytes: int = 0
    conversion_steps: int = 0
    conversion_bytes: int = 0
    #: kernel launches of one forward, by launch counter
    #: (``expected_launches``)
    launches: Optional[Dict[str, int]] = None
    #: the selection's predicted cost of one forward, ms
    predicted_ms: float = 0.0

    @property
    def layout_copy_bytes(self) -> int:
        """Bytes one forward's joins and layout conversions move."""
        return self.join_bytes + self.conversion_bytes

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The eager walk on a device tensor (TF32 off)."""
        with true_f32():
            if self.batch == 1:
                out = self.fn(x.unsqueeze(0), self.params)
                return {k: v.squeeze(0) for k, v in out.items()}
            return self.fn(x, self.params)

    def __call__(self, x):
        if not (self.jit and self.device.type == "cuda"
                and self.mesh is None):
            with span("copy_in"):
                x = _tensor(x, self.device)
            return self.forward(x)
        if self.graph is None:
            with _CAPTURE_LOCK:
                if self.graph is None:
                    self.graph = CapturedForward(self.forward,
                                                 _host_tensor(x),
                                                 self.device)
        return self.graph.run(x)

    @property
    def capture_launches(self) -> Optional[Dict[str, int]]:
        """Kernel launches of one replay, as the capture recorded them;
        None before the capture (or without one)."""
        return None if self.graph is None else dict(self.graph.launches)

    def synchronize(self) -> None:
        """Wait for the work this thread queued for the executable: its
        graph's stream, or the current stream for the eager walk (never a
        device-wide synchronisation, which would break another thread's
        capture)."""
        if self.device.type == "cuda":
            (self.graph.stream if self.graph is not None else
             torch.cuda.current_stream(self.device)).synchronize()


def compile_plan(sel: SelectionResult, raw_params: Dict[str, Dict],
                 jit: bool = True, fuse_across_layers: bool = False,
                 batch: int = 1, mesh: Optional[Any] = None,
                 device=None,
                 outputs: Optional[Sequence[str]] = None) -> CompiledNet:
    """Pack the weights and wire the executable of a selection.

    ``raw_params`` is a ``Net.init_params`` dict (numpy) or the output
    of :func:`params_from_numpy`; conv weights are packed by each
    primitive's ``prepare`` on the host, as the reference packs them,
    then moved to ``device`` — the card unless the caller asks for the
    CPU (with no GPU present this raises).

    ``jit=True`` on a card stages the forward as one CUDA graph, the
    counterpart of the reference's ``jax.jit``: the first call warms up
    and captures (:class:`CapturedForward`), every call after replays
    it, and the outputs are the eager walk's bits.  On the CPU ``jit``
    has no effect.  ``jit=False`` is the eager walk: one host dispatch
    per operator, so per-layer costs compose additively as in the
    paper's library-call system.  ``fuse_across_layers`` is accepted for
    the reference's signature and has no effect: eager calls never fuse
    across layers, and a graph replays the same kernels.

    ``batch > 1`` builds a batched executable: input (N, C, H, W), every
    output with a leading N axis, one call per primitive for the whole
    batch.

    ``outputs`` names the nodes whose values the executable returns,
    each in logical CHW; the default is the net's sinks, as in the
    reference.  Naming inner nodes (every conv, the logits before the
    softmax) lets a check compare two plans layer by layer.

    **Transform fusion pass.**  Edges the selection realized as fused
    (``sel.fusions``) get no ``convert_layout`` call: the consumer's
    maker is built via ``Primitive.make_fused`` to read the producer's
    layout in its prologue (kind ``"in"``), or the producer's to emit
    the consumer's layout in its epilogue (kind ``"out"``).

    **Mesh-sharded executables.**  ``mesh`` (a ``DeviceMesh`` of the
    executable's device type, with ``batch > 1``) realizes the plan's
    device placements in SPMD form: every rank of the mesh calls
    ``compile_plan`` with the same selection and then the executable
    with the same full batch, and every rank gets the full outputs — a
    drop-in for the single-device batched executable.  Each rank packs
    only its own weights: a ``tp`` conv's 1/d_tp output-channel shard.
    The ranks first all-gather a fingerprint of the plan (each node's
    primitive, layouts and placement, the edges, the batch and the
    outputs) and raise if any two differ: a cost model that ranks
    differently per process must not pass silently, and a collective
    that another rank never joins would hang.  A mesh executable runs
    the eager walk on every device: its collectives cannot be captured
    in a CUDA graph (a capture would record no communication), so
    ``jit`` is accepted and has no effect there, as
    ``fuse_across_layers`` is.  A collective's failure raises to the
    caller.
    """
    _COMPILE_COUNTER.add()
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if mesh is not None and batch < 2:
        raise ValueError("mesh-sharded executables are batched: pass "
                         "batch >= 2 (a single image cannot be sharded "
                         "over the data axis)")
    dev = resolve_device(device)
    net = sel.net
    dp_nodes = tp_nodes = pp_nodes = 0
    d_tp = 1
    kinds: Dict[str, str] = {}
    if mesh is not None:
        mesh_shape = mesh_shape_dict(mesh)
        if mesh.device_type != dev.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot run a "
                             f"{dev.type} executable")
        # dp shards the batch over ALL non-stage axes (data x model),
        # mirroring the solver's pricing (selection._mesh_dims)
        batch_axes = tuple(a for a in ("data", "model")
                           if a in mesh_shape)
        d_mesh = int(np.prod([mesh_shape[a] for a in batch_axes]))
        kinds = {nid: Placement.parse(ch.placement).kind
                 for nid, ch in sel.choices.items()}
        dp_nodes = sum(1 for k in kinds.values() if k == "dp")
        tp_nodes = sum(1 for k in kinds.values() if k == "tp")
        pp_nodes = sum(1 for k in kinds.values() if k == "pp")
        if dp_nodes and (d_mesh <= 1 or batch % d_mesh):
            raise ValueError(
                f"plan has {dp_nodes} dp nodes but mesh {mesh_shape} "
                f"cannot shard batch {batch} over its batch axes "
                f"{batch_axes}")
        if tp_nodes:
            d_tp = int(mesh_shape.get("model", 1))
            d_data = int(mesh_shape.get("data", 1))
            if d_tp <= 1:
                raise ValueError(
                    f"plan has {tp_nodes} tp nodes but mesh "
                    f"{mesh_shape} has no 'model' axis to shard "
                    f"weights over")
            if batch % d_data:
                raise ValueError(
                    f"tp plans keep the batch data-sharded: batch "
                    f"{batch} does not divide over the 'data' axis "
                    f"of {mesh_shape}")
        if pp_nodes:
            if "stage" not in mesh_shape:
                raise ValueError(
                    f"plan has {pp_nodes} pp nodes but mesh "
                    f"{mesh_shape} has no 'stage' axis")
            if pp_nodes != len(net.order):
                raise ValueError(
                    "pipeline plans are all-or-nothing: "
                    f"{pp_nodes}/{len(net.order)} nodes carry a pp "
                    "placement")
        for node in net.conv_nodes():
            if kinds[node.id] == "tp" and node.scn.m % d_tp:
                raise ValueError(
                    f"tp node {node.id}: m={node.scn.m} does not "
                    f"divide over d_tp={d_tp}")
    t0 = time.perf_counter()

    # fusion pass: effective wire layouts per conv node.  Kind "in"
    # means the consumer reads the producer's declared l_out; kind
    # "out" means the (single-consumer) producer emits the consumer's
    # l_in.
    fusions = sel.fusions
    eff_in: Dict[str, str] = {}
    eff_out: Dict[str, str] = {}
    for (src, dst), kind in fusions.items():
        if kind == "in":
            eff_in[dst] = sel.choices[src].l_out
        elif kind == "out":
            eff_out[src] = sel.choices[dst].l_in
        else:
            raise ValueError(f"unknown fusion kind {kind!r} on edge "
                             f"({src}, {dst})")

    outs = net.outputs() if outputs is None else list(outputs)
    unknown = [o for o in outs
               if o not in net.nodes or net.nodes[o].kind == "input"]
    if unknown:
        raise ValueError(f"outputs {unknown} are not computed nodes of "
                         f"{net.name}")
    # the layout each returned value is produced in: a conv whose
    # epilogue was fused emits its consumer's layout
    out_layouts = {nid: eff_out.get(nid, sel.choices[nid].l_out)
                   for nid in outs}
    if mesh is not None:
        _check_same_plan(sel, mesh, batch, outs)

    packed: Dict[str, Any] = {}
    makers: Dict[str, Callable] = {}
    for nid in net.order:
        node = net.nodes[nid]
        ch = sel.choices[nid]
        if node.kind == "conv":
            p = raw_params[nid]
            w, b = _host(p["w"]), _host(p["b"])
            scn, l_in, l_out = node.scn, eff_in.get(nid, ch.l_in), \
                eff_out.get(nid, ch.l_out)
            if kinds.get(nid) == "tp":
                # tp conv: this rank packs its own 1/d_tp slab of the
                # output channels at the shard scenario (the reference
                # packs all d_tp and shards the stack over 'model').
                # Fusion is never offered on tp edges, so the maker
                # wires the primitive's own l_in/l_out.
                msh = scn.m // d_tp
                j = mesh.get_local_rank("model")
                scn = scn.with_(m=msh)
                w, b = w[j * msh:(j + 1) * msh], b[j * msh:(j + 1) * msh]
                l_in, l_out = ch.l_in, ch.l_out
            prep = ch.primitive.prepare(scn, w, b)
            packed[nid] = {k: _tensor(v, dev) for k, v in prep.items()}
            makers[nid] = ch.primitive.make_fused(scn, l_in=l_in,
                                                  l_out=l_out)
        elif node.kind == "op" and nid in raw_params:
            packed[nid] = {k: _tensor(v, dev)
                           for k, v in raw_params[nid].items()}

    mode = ""
    if mesh is None:
        fn = _image_walker(sel, net, makers, out_layouts)
    elif pp_nodes:
        fn = _build_pipeline_fn(sel, net, makers, out_layouts, mesh,
                                batch)
        mode = "pipeline"
    else:
        fn = _build_mesh_fn(sel, net, makers, out_layouts, mesh, batch,
                            kinds)
        # the reference's names: its all-dp fast path, its partitioned
        # {dp, rep} program, its explicit tp walker
        mode = "tp_shard_map" if tp_nodes else "shard_map" \
            if dp_nodes == len(net.order) and d_mesh > 1 else "gspmd"
    plan_counts = dict(layout_copies(sel, out_layouts, batch),
                       launches=expected_launches(sel),
                       predicted_ms=1e3 * float(sel.predicted_cost))
    cnet = CompiledNet(sel, fn, packed, dev,
                       build_s=time.perf_counter() - t0, batch=batch,
                       fused_edges=len(fusions), makers=makers,
                       out_layouts=out_layouts, jit=jit, mesh=mesh,
                       dp_nodes=dp_nodes, mesh_mode=mode,
                       tp_nodes=tp_nodes, pp_nodes=pp_nodes, **plan_counts)
    get_tracer().emit("compile", t0, time.perf_counter(),
                      nodes=len(net.order), batch=batch,
                      fused_edges=cnet.fused_edges, mesh_mode=mode,
                      dp_nodes=dp_nodes, tp_nodes=tp_nodes,
                      pp_nodes=pp_nodes, **plan_counts)
    return cnet


def layout_copies(sel: SelectionResult, out_layouts: Dict[str, str],
                  batch: int) -> Dict[str, int]:
    """What one forward at ``batch`` of ``sel``'s plan copies outside its
    convs: the concat nodes (``joins``) and the bytes they read and
    write, and the non-identity ``convert_layout`` steps the plan wires
    (each edge's chain, once per edge, and each node of ``out_layouts``
    converted from its layout to CHW) and the bytes they read and write.
    Every element is read once and written once."""
    net = sel.net

    def moved(nid: str) -> int:
        return 2 * F32_BYTES * batch * int(np.prod(net.nodes[nid].out_shape))

    joins = [nid for nid in net.order if net.nodes[nid].kind == "op"
             and net.nodes[nid].op.name == "concat"]
    # the node whose value each step converts
    steps = [src for (src, _), chain in sel.conversions.items()
             for a, b in zip(chain, chain[1:]) if a != b]
    steps += [nid for nid, lay in out_layouts.items() if lay != "CHW"]
    return {"joins": len(joins), "join_bytes": sum(map(moved, joins)),
            "conversion_steps": len(steps),
            "conversion_bytes": sum(map(moved, steps))}


def _image_walker(sel: SelectionResult, net: Net,
                  makers: Dict[str, Callable],
                  out_layouts: Dict[str, str]) -> Callable:
    """The DAG walk over a batch (N, C, H, W): the selected primitive per
    conv node, the op function per op node, the legalizer's conversion
    chains per mismatched edge, then the nodes of ``out_layouts``
    converted from the layout named there to logical CHW."""
    def run(x, params):
        vals: Dict[str, Any] = {}
        for nid in net.order:
            node = net.nodes[nid]
            if node.kind == "input":
                vals[nid] = x  # inputs arrive in logical CHW
                continue
            ins = []
            for src in node.inputs:
                v = vals[src]
                chain = sel.conversions.get((src, nid))
                if chain:
                    for a, b in zip(chain, chain[1:]):
                        v = convert_layout(v, a, b)
                ins.append(v)
            if node.kind == "conv":
                vals[nid] = makers[nid](ins[0], params[nid])
            else:
                layout = LAYOUT_BY_NAME[sel.choices[nid].l_in]
                vals[nid] = node.op.fn(ins, layout, params.get(nid))
        return {nid: convert_layout(vals[nid], lay, "CHW")
                for nid, lay in out_layouts.items()}
    return run


def _plan_fingerprint(sel: SelectionResult, batch: int,
                     outputs: Sequence[str]) -> str:
    """A digest of what a mesh executable's ranks must agree on: each
    node's primitive, layouts and placement, the conversion chains and
    fusions, the batch and the returned nodes."""
    items = (sorted((nid, ch.primitive.name if ch.primitive else "",
                     ch.l_in, ch.l_out, ch.placement)
                    for nid, ch in sel.choices.items()),
             sorted((k, tuple(v)) for k, v in sel.conversions.items()),
             sorted(sel.fusions.items()), int(batch), list(outputs))
    return hashlib.sha256(repr(items).encode()).hexdigest()


def _check_same_plan(sel: SelectionResult, mesh, batch: int,
                     outputs: Sequence[str]) -> None:
    """All-gather every rank's plan fingerprint over the whole mesh and
    raise on every rank if any two differ."""
    group = _Axes(mesh, tuple(mesh.mesh_dim_names)).group
    got: List[Any] = [None] * dist.get_world_size(group)
    dist.all_gather_object(got, _plan_fingerprint(sel, batch, outputs),
                           group=group)
    differ = [k for k, f in enumerate(got) if f != got[0]]
    if differ:
        raise RuntimeError(
            f"the ranks of mesh {mesh_shape_dict(mesh)} compiled different "
            f"plans of {sel.net.name} (ranks {differ} of the mesh differ "
            f"from its first): every rank must compile the same selection, "
            f"batch and outputs")


class _Axes:
    """All-gathers and the shard index over some axes of a mesh.

    Several axes flatten with the first the most significant: shard
    ``i * d_1 + j`` sits at coordinate ``(i, j)``, the row-major order in
    which the reference's ``PartitionSpec(("data", "model"))`` splits a
    batch.  No axes: one shard, index 0, no collective.  One axis
    gathers over the mesh's group of that axis; several axes only where
    they span the whole world (a 2-D ``data`` x ``model`` mesh), over
    the world's group.  A mesh with a further axis (a ``stage`` beside
    ``data`` and ``model``) would need groups of its own and is refused.
    """

    def __init__(self, mesh, axes: Tuple[str, ...]) -> None:
        names = list(mesh.mesh_dim_names)
        dims = [names.index(a) for a in axes]
        sizes = [int(mesh.mesh.shape[d]) for d in dims]
        self.size = int(np.prod(sizes)) if dims else 1
        coord = mesh.get_coordinate()
        self.index = int(np.ravel_multi_index(
            [coord[d] for d in dims], sizes)) if dims else 0
        self.group = None
        if self.size == 1:
            return
        if len(axes) == 1:
            self.group = mesh.get_group(axes[0])
        elif len(axes) == len(names) and \
                mesh.mesh.numel() == dist.get_world_size():
            self.group = dist.group.WORLD
        else:
            raise NotImplementedError(
                f"a collective over axes {axes} of mesh "
                f"{mesh_shape_dict(mesh)}: the axes must be one, or span "
                f"a mesh of the whole world")
        # group rank -> shard index (group ranks follow global ranks)
        self.order = []
        for r in dist.get_process_group_ranks(self.group):
            c = (mesh.mesh == r).nonzero()[0].tolist()
            self.order.append(int(np.ravel_multi_index(
                [c[d] for d in dims], sizes)))

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every shard's ``t`` concatenated along ``dim`` in shard order
        (the reference's tiled ``all_gather``)."""
        if self.size == 1:
            return t
        t = t.contiguous()
        chunks = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(chunks, t, group=self.group)
        by_shard: List[Any] = [None] * self.size
        for q, k in enumerate(self.order):
            by_shard[k] = chunks[q]
        return torch.cat(by_shard, dim)


def _build_mesh_fn(sel: SelectionResult, net: Net,
                   makers: Dict[str, Callable],
                   out_layouts: Dict[str, str], mesh, batch: int,
                   kinds: Dict[str, str]):
    """The explicit-collective walker of a {dp, tp, rep} plan: the
    reference's ``_build_mesh_fn`` ("shard_map", "gspmd") and
    ``_build_tp_fn`` ("tp_shard_map") in one.

    ``dp`` shards the batch over *all* the mesh's batch axes (``data``
    and, when present, ``model`` — exactly the flattening the solver
    priced), so a pure-dp plan costs and runs the same on an ``(8,)``
    and a ``(2, 4)`` mesh: its input is sliced once, every node walks
    this rank's rows, and the outputs are all-gathered.
    Every value inside the walker carries one of three *forms* — how its
    leading batch axis is laid out across the mesh:

    * ``dp``  — ``batch / (d_data * d_tp)`` rows per rank (sharded over
      all batch axes);
    * ``ds``  — ``batch / d_data`` rows per rank (sharded over ``data``
      only, replicated across ``model``) — the working form of tp
      nodes, whose parallelism lives in the weight shards;
    * ``rep`` — the full batch everywhere.

    Form changes are exactly the collectives the solver's edge costs
    priced (``dp -> rep``/``dp -> ds``/``ds -> rep``: tiled all-gathers;
    the reverse directions: local slices at the reference's row
    offsets).  A tp conv runs its maker on the rank's weight shard (1/d_tp
    of the output channels), converts to logical CHW, all-gathers the
    channel axis across ``model``, and converts back — the intra-group
    collective the node's setup cost carried.  The input arrives whole
    on every rank; each output leaves whole (``rep``).
    """
    mesh_shape = mesh_shape_dict(mesh)
    d_data = int(mesh_shape.get("data", 1))
    d_tp = int(mesh_shape.get("model", 1))
    ax_dp = _Axes(mesh, tuple(a for a in ("data", "model")
                              if a in mesh_shape))
    ax_data = _Axes(mesh, ("data",) if "data" in mesh_shape else ())
    ax_model = _Axes(mesh, ("model",) if "model" in mesh_shape else ())
    i, j = ax_data.index, ax_model.index

    FORM = {"dp": "dp", "tp": "ds", "rep": "rep"}
    form_of = {nid: FORM[kinds[nid]] for nid in net.order}
    rows = {"dp": batch // (d_data * d_tp), "ds": batch // d_data,
            "rep": batch}

    def reform(v, src, dst):
        if src == dst or rows[src] == rows[dst]:
            return v
        if src == "dp" and dst == "rep":
            return ax_dp.gather(v, 0)
        if src == "dp" and dst == "ds":
            return ax_model.gather(v, 0)
        if src == "ds" and dst == "rep":
            return ax_data.gather(v, 0)
        # remaining directions drop rows: purely local slices
        if src == "rep" and dst == "dp":
            start = (i * d_tp + j) * rows["dp"]
        elif src == "rep" and dst == "ds":
            start = i * rows["ds"]
        elif src == "ds" and dst == "dp":
            start = j * rows["dp"]
        else:
            raise AssertionError(f"unreachable reform {src}->{dst}")
        return v[start:start + rows[dst]]

    def convert(v, chain):
        if chain:
            for a, b in zip(chain, chain[1:]):
                v = convert_layout(v, a, b)
        return v

    def bring(v, src, dst, chain):
        # convert layouts on whichever side holds fewer rows — the
        # same min-rows discount the edge's transform cost applied
        if rows[dst] <= rows[src]:
            return convert(reform(v, src, dst), chain)
        return reform(convert(v, chain), src, dst)

    def run(x, params):
        vals: Dict[str, Any] = {}
        for nid in net.order:
            node = net.nodes[nid]
            ch = sel.choices[nid]
            form = form_of[nid]
            if node.kind == "input":
                vals[nid] = reform(x, "rep", form)
                continue
            ins = [bring(vals[src], form_of[src], form,
                         sel.conversions.get((src, nid)))
                   for src in node.inputs]
            if node.kind == "conv":
                y = makers[nid](ins[0], params[nid])
                if kinds[nid] == "tp":
                    lo = ch.l_out
                    y = convert_layout(ax_model.gather(
                        convert_layout(y, lo, "CHW"), 1), "CHW", lo)
                vals[nid] = y
            else:
                vals[nid] = node.op.fn(ins, LAYOUT_BY_NAME[ch.l_in],
                                       params.get(nid))
        return {nid: reform(convert_layout(vals[nid], lay, "CHW"),
                            form_of[nid], "rep")
                for nid, lay in out_layouts.items()}
    return run


def _build_pipeline_fn(sel: SelectionResult, net: Net,
                       makers: Dict[str, Callable],
                       out_layouts: Dict[str, str], mesh, batch: int):
    """Lower a pp-placed plan onto the GPipe fill-drain schedule.

    The solver only offers pp placements on :func:`~repro_torch.core.
    selection.pp_chain` nets — a linear, shape-preserving chain — and
    its infinite backward-hop edge costs guarantee stages are monotone
    along the chain.  Each mesh stage therefore owns one contiguous run
    of nodes: this rank's run is its stage function, and
    ``pp_microbatches(batch, S)`` microbatches stream through
    :func:`~repro_torch.runtime.pipeline_parallel.pipeline_apply`.

    Stage boundaries are wired in logical CHW: the legalizer recorded
    each cross-stage edge's conversion chain *through* CHW, so the
    producing stage applies the ``l_out -> CHW`` prefix and the
    consuming stage the ``CHW -> l_in`` suffix — the carry rotated
    between stages is always the CHW activation the edge cost priced.
    Stages that own no nodes (more stages than layers) are relays.

    The chain's last node is the pipeline's result.  An inner node named
    in ``outputs`` is banked, in CHW, by the stage that computes it, one
    microbatch per call, and broadcast from that stage at the end.
    """
    from ..runtime.pipeline_parallel import pipeline_apply

    s = int(mesh_shape_dict(mesh)["stage"])
    n_micro = pp_microbatches(batch, s)
    mb = batch // n_micro
    order = net.order
    stage_of = {nid: Placement.parse(sel.choices[nid].placement).stage
                for nid in order}
    me = mesh.get_local_rank("stage")
    group = mesh.get_group("stage")
    mine = [(pos, nid) for pos, nid in enumerate(order)
            if stage_of[nid] == me]
    banked_ids = [nid for nid in out_layouts if nid != order[-1]]
    c, h, w = net.nodes[order[0]].out_shape

    def run(x, params):
        banked: Dict[str, List[torch.Tensor]] = {
            nid: [] for nid in banked_ids if stage_of[nid] == me}

        def stage_fn(_, v):
            # this rank's stage: (mb, C, H, W) CHW carry -> the same
            for pos, nid in mine:
                node = net.nodes[nid]
                ch = sel.choices[nid]
                if node.kind != "input":
                    prev = order[pos - 1]
                    chain = sel.conversions.get((prev, nid))
                    if chain and stage_of[prev] != me:
                        # cross-stage edge: the wire arrived in CHW;
                        # apply only the CHW -> l_in suffix
                        chain = chain[chain.index("CHW"):]
                    if chain:
                        for a, b in zip(chain, chain[1:]):
                            v = convert_layout(v, a, b)
                    if node.kind == "conv":
                        v = makers[nid](v, params[nid])
                    else:
                        v = node.op.fn([v], LAYOUT_BY_NAME[ch.l_in],
                                       params.get(nid))
                    if nid in banked:
                        banked[nid].append(
                            convert_layout(v, out_layouts[nid], "CHW"))
                # exit wire: if the chain leaves this stage after nid,
                # park the carry in CHW for the boundary transfer
                nxt = order[pos + 1] if pos + 1 < len(order) else None
                if nxt is None or stage_of[nxt] != me:
                    nchain = (sel.conversions.get((nid, nxt))
                              if nxt is not None else None)
                    if nchain:
                        hops = nchain[:nchain.index("CHW") + 1]
                        for a, b in zip(hops, hops[1:]):
                            v = convert_layout(v, a, b)
                    else:
                        v = convert_layout(v, ch.l_out, "CHW")
            return v

        y = pipeline_apply(mesh, stage_fn, {},
                           x.reshape(n_micro, mb, c, h, w),
                           n_micro=n_micro)
        res = {}
        for nid in out_layouts:
            if nid == order[-1]:
                res[nid] = y.reshape(batch, c, h, w)
                continue
            if nid in banked:
                t = torch.stack(banked[nid]).reshape(
                    batch, *net.nodes[nid].out_shape)
            else:
                t = torch.empty((batch, *net.nodes[nid].out_shape),
                                dtype=x.dtype, device=x.device)
            if s > 1:
                dist.broadcast(t, src=dist.get_global_rank(
                    group, stage_of[nid]), group=group)
            res[nid] = t
        return res
    return run


def measure(cnet: CompiledNet, x_chw, *, reps: int = 5,
            warmup: int = 1) -> Dict[str, float]:
    """Wall-time one forward pass (the paper's whole-network benchmark:
    mean of ``reps`` iterations after warmup), each ending in a device
    synchronisation on the card."""
    x = _tensor(x_chw, cnet.device)

    def sync():
        if cnet.device.type == "cuda":
            torch.cuda.synchronize(cnet.device)

    for _ in range(warmup):
        cnet(x)
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        cnet(x)
        sync()
        times.append(time.perf_counter() - t0)
    return {"mean_s": float(np.mean(times)),
            "min_s": float(np.min(times)),
            "std_s": float(np.std(times))}
