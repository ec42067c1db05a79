"""Execution of an instantiated DNN on PyTorch: the paper's "simple code
generator which emitted calls to primitive operations".

Port of the single-device part of the reference's ``core/plan.py``.  The
executable walks the DAG in topological order, calling the selected
primitive per conv layer, the op function per op node and the explicit
layout-conversion chains the legalizer inserted on illegal edges.  It
runs eagerly: there is no ``jax.jit`` to stage, no optimization barrier
to place (eager calls never fuse across layers), and a batch is a
leading axis written out through every primitive and kernel instead of
a ``vmap``.  Mesh-sharded executables are the ROADMAP's slice G.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..kernels.common import resolve_device, true_f32
from ..obs.metrics import default_registry
from ..obs.trace import get_tracer
from .graph import Net
from .layouts import LAYOUT_BY_NAME
from .primitives import convert_layout
from .selection import SelectionResult

__all__ = ["compile_plan", "CompiledNet", "measure", "compile_count",
           "params_from_numpy"]

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

    def __call__(self, x):
        x = _tensor(x, self.device)
        with true_f32():
            if self.batch == 1:
                out = self.fn(x.unsqueeze(0), self.params)
                return {k: v.squeeze(0) for k, v in out.items()}
            return self.fn(x, self.params)


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

    ``jit`` and ``fuse_across_layers`` are accepted for the reference's
    signature and have no effect: the executable runs eagerly, and
    eager calls never fuse across layers, so per-layer costs compose
    additively as in the paper's library-call system.

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
                       fused_edges=len(fusions), makers=makers)
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
