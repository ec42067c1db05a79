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
as in the paper.  Mesh-sharded executables are the ROADMAP's slice G.
"""
from __future__ import annotations

import gc
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..kernels.common import (add_launches, recording_launches,
                              resolve_device, true_f32)
from ..obs.metrics import default_registry
from ..obs.trace import get_tracer
from .graph import Net
from .layouts import LAYOUT_BY_NAME
from .primitives import convert_layout
from .selection import SelectionResult

__all__ = ["compile_plan", "CompiledNet", "CapturedForward", "measure",
           "compile_count", "params_from_numpy"]

#: process-wide count of compile_plan() calls (the obs registry's locked
#: counter, as in the reference)
_COMPILE_COUNTER = default_registry().counter("compile_plan_calls")


def compile_count() -> int:
    return _COMPILE_COUNTER.value


def _tensor(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


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


class CapturedForward:
    """One executable's forward as a CUDA graph, and the stream it runs on.

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

    :meth:`run` copies the input into the static buffer, replays the
    graph and returns clones of the static outputs (a later call does not
    overwrite them), all on the graph's stream under a lock, with the
    caller's stream ordered before and after.  The launch counts see the
    warm-up's launches and each replay's, never the capture's: a capture
    records kernels and launches none.  The graph reads the
    executable's packed parameters at the addresses they had at capture.
    """

    def __init__(self, forward: Callable, x: torch.Tensor,
                 device: torch.device) -> None:
        self.stream = torch.cuda.Stream(device)
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
        #: kernel launches the capture recorded, which it did not count:
        #: each replay launches them, and :meth:`run` counts them there
        self.launches: Dict[str, int] = dict(rec)
        #: replays so far
        self.replays = 0

    def run(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if x.shape != self.static_in.shape:
            raise ValueError(f"the graph was captured for input "
                             f"{tuple(self.static_in.shape)}, got "
                             f"{tuple(x.shape)}")
        caller = torch.cuda.current_stream(self.static_in.device)
        with self._lock:
            self.stream.wait_stream(caller)
            with torch.cuda.stream(self.stream):
                self.static_in.copy_(x)
                self.graph.replay()
                out = {k: v.clone() for k, v in self.static_out.items()}
                self.replays += 1
            add_launches(self.launches)
            caller.wait_stream(self.stream)
        if x.is_cuda:
            x.record_stream(self.stream)
        for v in out.values():
            v.record_stream(caller)
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
    #: the reference's mesh, read by the server and the reliability
    #: layer: always None, a single-device executable (mesh modes are
    #: slice G)
    mesh: Optional[Any] = None

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The eager walk on a device tensor (TF32 off)."""
        with true_f32():
            if self.batch == 1:
                out = self.fn(x.unsqueeze(0), self.params)
                return {k: v.squeeze(0) for k, v in out.items()}
            return self.fn(x, self.params)

    def __call__(self, x):
        if not (self.jit and self.device.type == "cuda"):
            return self.forward(_tensor(x, self.device))
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if self.graph is None:
            with _CAPTURE_LOCK:
                if self.graph is None:
                    self.graph = CapturedForward(self.forward, x,
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
    """
    _COMPILE_COUNTER.add()
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded executables are not ported yet (ROADMAP slice "
            "G, multi-device)")
    dev = resolve_device(device)
    net = sel.net
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

    packed: Dict[str, Any] = {}
    makers: Dict[str, Callable] = {}
    for nid in net.order:
        node = net.nodes[nid]
        ch = sel.choices[nid]
        if node.kind == "conv":
            p = raw_params[nid]
            prep = ch.primitive.prepare(node.scn, _host(p["w"]),
                                        _host(p["b"]))
            packed[nid] = {k: _tensor(v, dev) for k, v in prep.items()}
            makers[nid] = ch.primitive.make_fused(
                node.scn, l_in=eff_in.get(nid, ch.l_in),
                l_out=eff_out.get(nid, ch.l_out))
        elif node.kind == "op" and nid in raw_params:
            packed[nid] = {k: _tensor(v, dev)
                           for k, v in raw_params[nid].items()}

    cnet = CompiledNet(sel, _image_walker(sel, net, makers, out_layouts),
                       packed, dev,
                       build_s=time.perf_counter() - t0, batch=batch,
                       fused_edges=len(fusions), makers=makers,
                       out_layouts=out_layouts, jit=jit)
    get_tracer().emit("compile", t0, time.perf_counter(),
                      nodes=len(net.order), batch=batch,
                      fused_edges=cnet.fused_edges, mesh_mode="",
                      dp_nodes=0, tp_nodes=0, pp_nodes=0)
    return cnet


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
