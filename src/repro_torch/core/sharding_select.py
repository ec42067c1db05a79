"""PBQP sharding selection — the paper's technique at datacenter scale.

Port of the reference's ``core/sharding_select.py``.  The analogy:

  CPU world (paper)                  mesh world (this module)
  -----------------                  ------------------------
  data layout of a tensor            partition spec of a tensor
  primitive {L_in, P, L_out}         op variant + sharding rule-set
  layout transform routine           resharding collective
  DT-graph APSP cost                 collective bytes / link bandwidth
  profiled layer cost                analytic compute+comm time per rule

PBQP nodes are the tensor groups of one transformer program (embed,
residual stream, attention, FFN/MoE, head, kv-cache); domains are
feasibility-filtered sharding rule-sets; node costs price the
collectives a rule implies *inside* its group (e.g. Megatron row-
parallel out-proj => per-layer all-reduce of the activations); edge
costs price the resharding between adjacent groups.  The instance is
built through the unified choice-space bridge
(:mod:`repro_torch.core.choice_space`) and solved by the same exact
PBQP solver (:mod:`repro_torch.core.pbqp`) the layout-level selection
uses.

Hardware comes from a :class:`~repro_torch.core.costs.HardwareSpec`,
by default :data:`~repro_torch.core.costs.H100_SPEC` (the port's target
card; the reference defaults to its TPU's spec, which the port does not
carry): ``peak_flops`` prices the matmuls, ``mem_bw`` replicated reads,
``link_bw`` every collective through the shared helpers in
:mod:`repro_torch.core.costs`.  Given the same spec, the assignment and
the predicted time equal the reference's.  The rules it returns shard a
model on a ``DeviceMesh`` through :class:`~repro_torch.models.sharding.
ShardingPlan`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..models.sharding import MEGATRON_RULES
from . import pbqp
from .choice_space import ChoiceEdge, ChoiceNode, build_pbqp, drop_infinite
from .costs import (
    H100_SPEC, HardwareSpec, all_gather_time, all_reduce_time,
    all_to_all_time, reduce_scatter_time, send_time,
)

__all__ = ["select_rules", "candidate_report", "ShardingChoice"]


@dataclass(frozen=True)
class ShardingChoice:
    name: str
    #: logical-axis updates this choice contributes to the global Rules
    updates: Tuple[Tuple[str, object], ...]
    #: activation "layout" on the residual stream this choice assumes
    #: ("rep" replicated over model axis, "sp" sequence-sharded)
    stream: str = "rep"


def _bytes(*dims, dtype_bytes=2):
    return float(np.prod(dims)) * dtype_bytes


def _mesh_size(mesh_shape: Dict[str, int], axis) -> int:
    if axis is None:
        return 1
    axes = (axis,) if isinstance(axis, str) else axis
    return int(np.prod([mesh_shape[a] for a in axes]))


def select_rules(cfg, shape, mesh_shape: Dict[str, int], *,
                 spec: HardwareSpec = H100_SPEC,
                 exact: bool = True, fsdp: bool = False,
                 return_solution: bool = False):
    """Solve the sharding PBQP for (arch, shape) on a mesh.

    Returns (Rules, report) where report logs domains, costs and the
    chosen assignment.
    """
    tp = mesh_shape.get("model", 1)
    dp = _mesh_size(mesh_shape, tuple(a for a in ("pod", "data")
                                      if a in mesh_shape))
    b_local = max(shape.global_batch // dp, 1)
    t = shape.seq_len if shape.kind != "decode" else 1
    d, v = cfg.d_model, cfg.vocab
    hd = cfg.resolved_head_dim if cfg.n_heads else 0
    nl = cfg.n_layers
    act = _bytes(b_local, t, d)          # residual activation per device

    bwd = 3.0 if shape.kind == "train" else 1.0  # fwd+bwd flops factor

    def mm_time(flops: float, ways: int) -> float:
        """Matmul time when sharded ``ways`` ways (``spec.peak_flops``
        is the achievable-rate proxy)."""
        return bwd * flops / (max(ways, 1) * spec.peak_flops)

    def xfer(nbytes: float, n: int) -> float:
        """Naive (non-ring) fabric transfer over an ``n``-wide group:
        the one-exchange collectives below that don't follow the ring
        model.  Routed through the shared guarded helper so a 1-wide
        group prices 0.0 — exactly rep-equivalent — and a fabric-less
        spec (``link_bw == 0``) prices infinite; selection then
        replicates.  (Regression: this once divided by ``link_bw``
        unconditionally, so a degenerate tp=1 mesh still paid fabric
        time and could flip plans away from the rep optimum.)"""
        return send_time(spec, nbytes, n)

    nodes: List[ChoiceNode] = []
    domains: Dict[str, List[ShardingChoice]] = {}

    def add(node: str, choices: List[Tuple[ShardingChoice, float]]):
        choices = drop_infinite(choices)
        domains[node] = [c for c, _ in choices]
        nodes.append(ChoiceNode(node, [c for c, _ in choices],
                                [c for _, c in choices]))

    # ---------------- embed ----------------
    emb = []
    if v % tp == 0:
        # vocab-sharded gather -> all-reduce of the (b,t,d) activations
        # (naive, not ring: the partitioner reassembles the one-hot
        # gather output in a single exchange)
        emb.append((ShardingChoice("embed:vocab", (("vocab", "model"),)),
                    xfer(2 * act, tp)))
    if d % tp == 0:
        emb.append((ShardingChoice("embed:dmodel",
                                   (("vocab", None),)),  # d sharded in rule
                    all_gather_time(spec, act, tp)))
    emb.append((ShardingChoice("embed:rep", (("vocab", None),)),
                0.0))  # replicated: no collective
    add("embed", emb)

    # ---------------- attention (or mamba mixer) ----------------
    attn = []
    n_tok = b_local * t
    if cfg.is_attention_free:
        d_inner = cfg.ssm_expand * d
        h_ssm = d_inner // cfg.ssm_headdim
        f_ssm = 2 * n_tok * d * (2 * d_inner + 2 * cfg.ssm_state) * nl
        if h_ssm % tp == 0:
            attn.append((ShardingChoice(
                "mixer:ssm_heads", (("ssm_heads", "model"),)),
                mm_time(f_ssm, tp) + nl * xfer(2 * act, tp)))
        attn.append((ShardingChoice("mixer:rep", (("ssm_heads", None),)),
                     mm_time(f_ssm, 1)))
    else:
        # projections + score/PV flops per layer stack
        f_proj = 2 * n_tok * d * (cfg.n_heads + 2 * cfg.n_kv_heads +
                                  cfg.n_heads) * hd * nl
        kv_len = shape.seq_len if shape.kind == "decode" else t
        f_sc = 4 * b_local * t * kv_len * cfg.n_heads * hd * nl
        f_attn = f_proj + f_sc
        if cfg.n_heads % tp == 0:
            # Megatron head-parallel: out-proj row-parallel all-reduce
            kv_ax = "model" if cfg.n_kv_heads % tp == 0 else None
            attn.append((ShardingChoice(
                "attn:heads", (("heads", "model"), ("kv_heads", kv_ax))),
                mm_time(f_attn, tp) + nl * all_reduce_time(spec, act, tp)))
        if hd % tp == 0:
            # head_dim-parallel (whisper/llava fallback): QK^T contracts
            # over the sharded head_dim -> all-reduce of the FULL score
            # tensor (B, H, T, KV) per layer, priced at its full bytes
            # (as the reference prices it)
            score_b = _bytes(b_local, cfg.n_heads, t, 1) * kv_len
            attn.append((ShardingChoice(
                "attn:head_dim", (("head_dim", "model"),
                                  ("heads", None), ("kv_heads", None))),
                mm_time(f_attn, tp) +
                bwd * nl * (all_reduce_time(spec, act, tp) +
                            reduce_scatter_time(spec, score_b, tp))))
        attn.append((ShardingChoice(
            "attn:rep", (("heads", None), ("kv_heads", None))),
            mm_time(f_attn, 1)))
    add("attn", attn)

    # ---------------- ffn / moe ----------------
    ffn = []
    if cfg.n_experts:
        n_moe = nl // cfg.moe_every
        f_moe = 2 * n_tok * d * cfg.d_ff * 3 * cfg.top_k * n_moe
        if cfg.n_experts % tp == 0:
            # expert parallel: two all-to-alls of the dispatched tokens
            disp = _bytes(b_local, t, d) * cfg.top_k
            ffn.append((ShardingChoice("ffn:ep", (("experts", "model"),
                                                  ("d_ff", None))),
                        mm_time(f_moe, tp) +
                        n_moe * 2 * all_to_all_time(spec, disp, tp)))
        if cfg.d_ff % tp == 0:
            ffn.append((ShardingChoice("ffn:tp", (("experts", None),
                                                  ("d_ff", "model"))),
                        mm_time(f_moe, tp) +
                        n_moe * all_reduce_time(spec, act, tp)))
    elif cfg.d_ff:
        f_ffn = 2 * n_tok * d * cfg.d_ff * 3 * nl
        if cfg.d_ff % tp == 0:
            ffn.append((ShardingChoice("ffn:tp", (("d_ff", "model"),)),
                        mm_time(f_ffn, tp) +
                        nl * all_reduce_time(spec, act, tp)))
        ffn.append((ShardingChoice("ffn:rep", (("d_ff", None),)),
                    mm_time(f_ffn, 1)))
    else:  # pure SSM: no FFN at all
        ffn.append((ShardingChoice("ffn:none", ()), 0.0))
    add("ffn", ffn)

    # ---------------- residual stream "layout" ----------------
    stream = [
        (ShardingChoice("stream:rep", (("seq", None),), stream="rep"), 0.0),
    ]
    if t % tp == 0 and t > 1:
        # sequence parallelism: norms/elementwise run seq-sharded;
        # needs all-gather before attn + reduce-scatter after — costed
        # on the edges below
        stream.append(
            (ShardingChoice("stream:sp", (("seq", "model"),), stream="sp"),
             0.0))
    add("stream", stream)

    # ---------------- kv-cache (decode shapes) ----------------
    if shape.kind == "decode" and not cfg.is_attention_free:
        kv_bytes = _bytes(cfg.n_layers, shape.global_batch, shape.seq_len,
                          cfg.n_kv_heads * hd) * 2
        cache = []
        dp_ax = tuple(a for a in ("pod", "data") if a in mesh_shape)
        if shape.global_batch % dp == 0 and shape.global_batch >= dp:
            # batch-sharded cache: no attention collectives
            cache.append((ShardingChoice(
                "cache:batch", (("kv_seq", None),)), 0.0))
        if shape.seq_len % _mesh_size(mesh_shape, dp_ax) == 0:
            # sequence-sharded cache (long-context, small batch):
            # partial-softmax psum per step, tiny (B, H) stats
            cache.append((ShardingChoice(
                "cache:seq", (("kv_seq", dp_ax),
                              ("batch", None))),
                cfg.n_layers * xfer(_bytes(shape.global_batch,
                                           cfg.n_heads, hd + 2,
                                           dtype_bytes=4),
                                    _mesh_size(mesh_shape, dp_ax))))
        cache.append((ShardingChoice(
            "cache:replicated", (("kv_seq", None),)),
            kv_bytes / spec.mem_bw))  # every chip reads the whole cache
        add("cache", cache)

    # ---------------- head ----------------
    head = []
    if v % tp == 0:
        head.append((ShardingChoice("head:vocab", ()),
                     all_gather_time(
                         spec, _bytes(b_local, t, 1, dtype_bytes=4), tp)))
    head.append((ShardingChoice("head:rep", (("vocab", None),)),
                 _bytes(d, v) / spec.mem_bw))
    add("head", head)

    # ---------------- edges: resharding between stream and groups ----
    # stream "layout" transitions are the DT-graph edges of this choice
    # space: an SP stream costs one all-gather (rep -> needs full seq)
    # plus one reduce-scatter around every sharded compute group, and
    # composes only with sharded groups.
    edges: List[ChoiceEdge] = []

    def stream_group(sc: ShardingChoice, gc: ShardingChoice) -> float:
        if sc.stream != "sp":
            return 0.0
        # SP only composes with sharded compute groups
        if gc.name.endswith(":rep"):
            return np.inf
        # per-layer all-gather + reduce-scatter of activations
        return nl * (all_gather_time(spec, act, tp) +
                     reduce_scatter_time(spec, act, tp))

    # embed/head touch the stream once (not per layer): entering or
    # leaving a seq-sharded stream costs one activation all-gather,
    # regardless of which embed/head variant sits on the other end
    sp_boundary = all_gather_time(spec, act, tp)
    edges.append(ChoiceEdge("stream", "attn", stream_group))
    edges.append(ChoiceEdge("stream", "ffn", stream_group))
    edges.append(ChoiceEdge(
        "embed", "stream",
        lambda ec, sc: sp_boundary if sc.stream == "sp" else 0.0))
    edges.append(ChoiceEdge(
        "stream", "head",
        lambda sc, hc: sp_boundary if sc.stream == "sp" else 0.0))

    pb, _ = build_pbqp(nodes, edges)
    sol = pbqp.solve(pb, exact=exact)
    chosen = {n: domains[n][sol.assignment[n]] for n in domains}

    rules = MEGATRON_RULES
    # batch divisibility: keep the largest ("pod","data") prefix whose
    # product divides the global batch (B=1 long-context: replicate)
    b_axes = []
    prod = 1
    for ax in ("pod", "data"):
        if ax in mesh_shape and shape.global_batch % (
                prod * mesh_shape[ax]) == 0:
            b_axes.append(ax)
            prod *= mesh_shape[ax]
    rules = rules.with_(batch=tuple(b_axes) if b_axes else None)
    if fsdp:
        rules = rules.with_(layers=None)
    updates = {}
    for c in chosen.values():
        updates.update(dict(c.updates))
    if chosen["embed"].name == "embed:dmodel":
        updates["d_model"] = None  # keep activations unsharded on d
    rules = rules.with_(**updates)

    report = {
        "arch": cfg.name, "shape": shape.name,
        "mesh": dict(mesh_shape), "spec": spec.name,
        "assignment": {n: c.name for n, c in chosen.items()},
        "predicted_comm_s": sol.cost,
        "optimal": sol.optimal,
        "domains": {n: [c.name for c in domains[n]] for n in domains},
    }
    if return_solution:
        return rules, report, sol
    return rules, report


def candidate_report(cfg, shape, mesh_shape, *,
                     spec: HardwareSpec = H100_SPEC) -> Dict:
    _, report = select_rules(cfg, shape, mesh_shape, spec=spec)
    return report
