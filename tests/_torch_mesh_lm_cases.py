"""The LM mesh cases of the port's parity tests (slice G2), shared by
``tests/test_torch_mesh_lm.py``, ``tests/test_torch_card.py``'s
``TestMeshLM`` and ``chip_smoke.py``'s phase 15.

Two sides run the same cases on the same numpy inputs:

* the port's side: module-level functions that ``run_spmd`` runs on
  every rank of a gloo world (pickled by name, so this module imports
  neither ``jax`` nor ``repro``): CPU processes in the CPU tests, ranks
  sharing ``cuda:0`` on the card;
* the reference's side: :func:`reference`, which runs :data:`REF_SCRIPT`
  in one subprocess on 8 fake XLA CPU devices (as
  ``tests/_torch_mesh_cases.reference`` does) and writes every case's
  parameters and outputs to one ``.npz``.

Every rank returns full values (``DTensor.full_tensor()``) as numpy.
"""
from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
#: the LM parity tolerance (tests/test_torch_models.py's docstring)
REL = 1e-4
REL_ENCDEC = 3e-4
#: the MoE forward on 2 x 4 against the reference's mesh run: the
#: reference's GSPMD output lies 4.9e-5 from a float64 evaluation of the
#: same model and 5.6e-5 from its own single-device run, the port's
#: single-device output 5.7e-5 from float64, and the two f32 runs 1.08e-4
#: apart (measured on this case's inputs)
REL_MOE_REF = 2e-4
#: the encoder-decoder's training forward (logits at every position)
#: against the reference's mesh run: the reference's GSPMD output lies
#: 1.37e-3 from a float64 evaluation of the same model (its single-device
#: run 1.02e-3), the port's single-device output 2.1e-4 (measured on this
#: case's inputs); the last position's logits (prefill) keep REL_ENCDEC
REL_ENCDEC_FWD_REF = 3e-3
SMALL = dict(n_layers=2, d_model=64, d_ff=128, vocab=512, n_heads=4,
             n_kv_heads=2, head_dim=16)

#: case -> (arch, scaled_down overrides, mesh shape, axis names, rules,
#: what to run, ModelRuntime overrides, init seed).  "megatron" is
#: MEGATRON_RULES, "kv_rep" the same with the kv heads replicated (as
#: select_rules leaves them when they do not divide |model|).  The first
#: two are the reference's TestShardedModel cases.
LM_CASES = {
    "dense_loss_data4_model2": (
        "tinyllama-1.1b", SMALL, (4, 2), ("data", "model"), "megatron",
        "loss", {}, 0),
    "moe_fwd_data2_model4": (
        "grok-1-314b", dict(SMALL, n_experts=4, top_k=2), (2, 4),
        ("data", "model"), "megatron", "forward", {}, 1),
    "dense_serve_data2_model2": (
        "tinyllama-1.1b", SMALL, (2, 2), ("data", "model"), "megatron",
        "serve", {}, 0),
    "ssm_data2_model2": (
        "mamba2-2.7b", {}, (2, 2), ("data", "model"), "megatron", "serve",
        {"chunk": 8}, 0),
    "hybrid_data2_model2": (
        "jamba-v0.1-52b", dict(n_layers=8), (2, 2), ("data", "model"),
        "megatron", "serve", {"chunk": 8}, 0),
    "encdec_data2_model2": (
        "whisper-large-v3", {}, (2, 2), ("data", "model"), "megatron",
        "forward_prefill", {}, 0),
    "vlm_data2_model2": (
        "llava-next-34b", {}, (2, 2), ("data", "model"), "megatron",
        "serve", {}, 0),
    "gqa_model4_xla": (
        "tinyllama-1.1b", SMALL, (4,), ("model",), "kv_rep", "serve",
        {"attn_impl": "xla"}, 0),
    "gqa_model4_flash": (
        "tinyllama-1.1b", SMALL, (4,), ("model",), "kv_rep", "serve",
        {"attn_impl": "flash"}, 0),
}
#: the gradients on a mesh against one device: case -> (arch,
#: scaled_down overrides, rules, ModelRuntime overrides, tolerance: the
#: leaf-wise gradient tolerance of tests/test_torch_train.py's GRAD_REL
#: for the arch, whose f32 gradients the random weights amplify)
GRAD_CASES = {
    "grads_dense": ("tinyllama-1.1b", SMALL, "megatron", {}, 1e-4),
    "grads_alltoall": ("grok-1-314b", dict(SMALL, n_experts=4, top_k=2),
                       "megatron", {"moe_impl": "alltoall"}, 2e-3),
    "grads_hybrid": ("jamba-v0.1-52b", dict(n_layers=8), "megatron",
                     {"chunk": 8}, 2.5e-3),
    "grads_gqa": ("tinyllama-1.1b", SMALL, "kv_rep", {}, 1e-4),
}
#: the worlds of the CPU tests: mesh -> its cases (and the extra cases:
#: the all-to-all MoE, the compressed all-reduce, the elastic controller,
#: the gradients)
WORLDS = {
    "data4_model2": ("dense_loss_data4_model2",),
    "data2_model4": ("moe_fwd_data2_model4",),
    "data2_model2": ("dense_serve_data2_model2", "ssm_data2_model2",
                     "hybrid_data2_model2", "encdec_data2_model2",
                     "vlm_data2_model2", "alltoall", "compress", "elastic",
                     "two_axes", "grads_dense", "grads_alltoall",
                     "grads_hybrid"),
    "model4": ("gqa_model4_xla", "gqa_model4_flash", "grads_gqa"),
}
B_TRAIN, T_TRAIN = 8, 16
B_SERVE, T_PROMPT, MAX_SEQ, DECODE_STEPS = 4, 12, 20, 3
#: the all-to-all MoE case: a router skewed towards experts 0 and 1 and
#: capacity_factor 0.25, so each (batch x seq) slab of 16 tokens sends
#: 16 pairs to each of them against a capacity of 8: pairs drop
A2A = dict(arch="grok-1-314b", kw=dict(SMALL, n_experts=4, top_k=2,
                                       capacity_factor=0.25),
           shape=(4, 16), skew=4.0)
#: the compressed all-reduce: 4 ranks, one (64, 32) leaf each
COMPRESS = dict(world=4, shape=(64, 32))


def ref_tolerance(name, key):
    """The tolerance of output ``key`` against the reference's mesh
    output."""
    if name == "moe_fwd_data2_model4":
        return REL_MOE_REF
    if lm_config(name).family == "encdec":
        return REL_ENCDEC_FWD_REF if key == "fwd" else REL_ENCDEC
    return REL


def self_tolerance(name):
    """The tolerance against the port's own single-device run: the
    encoder-decoder amplifies f32 rounding as ``REL_ENCDEC`` says (its
    mesh and single-device forwards lie 2.1e-4 apart on these inputs,
    as far as the single-device run lies from float64)."""
    return REL_ENCDEC if lm_config(name).family == "encdec" else REL


def lm_config(name):
    from repro_torch.configs import get_config
    arch, kw = LM_CASES[name][:2]
    return get_config(arch).scaled_down(**kw)


def lm_rules(base, kind):
    """The case's rules from either package's ``MEGATRON_RULES``."""
    return base.with_(kv_heads=None) if kind == "kv_rep" else base


def lm_inputs(cfg, what, seed=0):
    """numpy inputs: the training batch (tokens, labels, and the
    encoder's frames or the VLM's patches), the prompt batch, and the
    decode steps' tokens."""
    rng = np.random.default_rng(seed)
    b, t = (B_TRAIN, T_TRAIN) if what in ("loss", "forward") else \
        (B_SERVE, T_PROMPT)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)}
    if what == "loss":
        batch["labels"] = rng.integers(0, cfg.vocab, (b, t)).astype(
            np.int32)
    if cfg.family == "encdec":
        batch["frames"] = (rng.normal(size=(b, cfg.enc_seq, cfg.d_model))
                           * 0.02).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = (rng.normal(size=(b, cfg.n_patches,
                                             cfg.d_model))
                            * 0.02).astype(np.float32)
    steps = [rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
             for _ in range(DECODE_STEPS)]
    return batch, steps


def input_axes(key):
    return {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
            "frames": ("batch", "enc_seq", "d_model"),
            "patches": ("batch", "seq", "d_model")}[key]


def a2a_operands():
    """The all-to-all case's input x."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=A2A["shape"] + (A2A["kw"]["d_model"],)).astype(
        np.float32)
    return x


def compress_operands():
    return np.random.default_rng(0).normal(
        size=(COMPRESS["world"],) + COMPRESS["shape"]).astype(np.float32)


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def unflatten(flat, prefix):
    tree = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        node = tree
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


# ---------------------------------------------------------------------
# the port's side: each function runs on every rank of a world
# ---------------------------------------------------------------------
def _run_model(cfg, params, plan, rt, what, batch_np, steps_np, device):
    """One case's outputs (full values, numpy) under ``plan``: the loss,
    the training forward's logits, or the prefill and decode logits."""
    import torch

    from repro_torch import models as T

    def place(x, axes):
        return plan.place(torch.from_numpy(x).to(device), axes)

    def full(x):
        x = x.full_tensor() if hasattr(x, "full_tensor") else x
        return x.detach().float().cpu().numpy()

    batch = {k: place(v, input_axes(k)) for k, v in batch_np.items()}
    out = {}
    with torch.no_grad():
        if what == "loss":
            out["loss"] = full(T.loss_fn(cfg, params, batch, plan, rt))
            return out
        if what in ("forward", "forward_prefill"):
            out["fwd"] = full(T.forward_train(cfg, params, batch, plan, rt))
            if what == "forward":
                return out
        logits, cache = T.prefill(cfg, params, batch, plan, rt,
                                  max_seq=MAX_SEQ + (cfg.n_patches or 0))
        out["prefill"] = full(logits)
        if what == "forward_prefill":
            return out
        pos = T_PROMPT + (cfg.n_patches or 0)
        for s, tok in enumerate(steps_np):
            logits, cache = T.decode_step(
                cfg, params, cache, place(tok, ("batch", "seq")), pos + s,
                plan, rt)
            out[f"dec{s}"] = full(logits)
    return out


def lm_world(names, ref_npz=None, device="cpu"):
    """Every case of ``names`` (one mesh) on this rank: the mesh run and
    the same model without a mesh, both from the reference's parameters
    (``ref_npz``) or, without it, the port's ``init_params`` of the
    case's seed.  Returns {case: {"mesh": outputs, "plain": outputs}}
    (plus the extra cases' own results)."""
    import torch
    import torch.distributed as dist

    from repro_torch import models as T
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import place_params

    ref = dict(np.load(ref_npz)) if ref_npz else {}
    res = {}
    mesh = None
    for name in names:
        if name in ("alltoall", "compress", "elastic", "two_axes"):
            res[name] = globals()[f"_{name}_case"](ref, device)
            continue
        if name in GRAD_CASES:
            res[name] = _grads_case(name, device)
            continue
        arch, kw, mshape, axes, rules, what, rt_kw, seed = LM_CASES[name]
        if mesh is None:
            mesh = make_mesh(mshape, axes, device)
        cfg = lm_config(name)
        plan = T.ShardingPlan(mesh=mesh, rules=lm_rules(
            T.MEGATRON_RULES, rules).restrict(axes))
        rt = T.ModelRuntime(**rt_kw)
        if ref:
            tree = unflatten(ref, f"{name}/params/")
            params = place_params(tree, T.param_defs(cfg), plan)
            p0 = T.params_from_numpy(tree, device=device)
        else:
            params = T.init_params(cfg, seed, torch.float32, device, plan)
            p0 = T.init_params(cfg, seed, torch.float32, device)
        batch, steps = lm_inputs(cfg, what)
        res[name] = {
            "mesh": _run_model(cfg, params, plan, rt, what, batch, steps,
                               device),
            "plain": _run_model(cfg, p0, T.ShardingPlan(), rt, what, batch,
                                steps, device)}
    res["rank"] = dist.get_rank()
    return res


def _grads_case(name, device):
    """``loss_and_grads`` on this world's mesh against one device, the
    port's ``init_params`` of seed 0 and a numpy batch: (the largest
    difference of each gradient leaf over that leaf's largest
    magnitude, the two losses)."""
    import torch
    import torch.distributed as dist

    from repro_torch import models as T
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.train_loop import loss_and_grads
    from repro_torch.tree import leaves
    arch, kw, rules, rt_kw, _ = GRAD_CASES[name]
    shape = (4,) if name == "grads_gqa" else (2, 2)
    axes = ("model",) if name == "grads_gqa" else ("data", "model")
    assert dist.get_world_size() == int(np.prod(shape))
    mesh = make_mesh(shape, axes, device)
    cfg = get_config(arch).scaled_down(**kw)
    plan = T.ShardingPlan(mesh=mesh, rules=lm_rules(
        T.MEGATRON_RULES, rules).restrict(axes))
    rt = T.ModelRuntime(**rt_kw)
    tok = np.random.default_rng(4).integers(0, cfg.vocab, (4, 17))
    b0 = {"tokens": torch.from_numpy(tok[:, :-1]).to(device),
          "labels": torch.from_numpy(tok[:, 1:]).to(device)}
    batch = {k: plan.place(v, ("batch", "seq")) for k, v in b0.items()}
    loss, grads = loss_and_grads(
        cfg, plan, rt, T.init_params(cfg, 0, torch.float32, device, plan),
        batch)
    loss0, grads0 = loss_and_grads(
        cfg, T.ShardingPlan(), rt,
        T.init_params(cfg, 0, torch.float32, device), b0)
    dists = [rel_dist(g.full_tensor().cpu().numpy(), g0.cpu().numpy())
             for g, g0 in zip(leaves(grads), leaves(grads0))]
    return {"grad": max(dists), "loss": float(loss.full_tensor()),
            "loss0": float(loss0)}


def _alltoall_case(ref, device):
    """``moe_ffn_alltoall`` on this rank's slab of the case's input over
    {data: 2, model: 2}, with the reference's parameters: the full
    output, and this rank's slab's keep mask (its own dispatch)."""
    import torch
    import torch.distributed as dist

    from repro_torch import models as T
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe

    cfg = get_config(A2A["arch"]).scaled_down(**A2A["kw"])
    mesh = make_mesh((2, 2), ("data", "model"), device)
    plan = T.ShardingPlan(mesh=mesh, rules=T.MEGATRON_RULES.restrict(
        ("data", "model")))
    p = {k: torch.from_numpy(v).to(device)
         for k, v in unflatten(ref, "alltoall/params/").items()}
    x = torch.from_numpy(a2a_operands()).to(device)
    pd = {k: plan.place(v, d.axes) for (k, v), d in zip(
        sorted(p.items()), (moe.moe_defs(cfg)[k] for k in sorted(p)))}
    xd = plan.place(x, ("batch", "seq", "d_model"))
    with torch.no_grad():
        y = moe.moe_ffn_alltoall(cfg, pd, xd, plan)
        xpl = plan.placements((("data",), "model", None))
        xl = xd.redistribute(mesh, xpl).to_local()
        c = moe.capacity(cfg, xl.shape[0] * xl.shape[1])
        _, meta = moe._local_dispatch(cfg, p, xl.reshape(-1, x.shape[-1]),
                                      c)
    return {"y": y.full_tensor().cpu().numpy(),
            "keep": meta[0].cpu().numpy(), "rank": dist.get_rank()}


def _compress_case(ref, device):
    """``compressed_psum_tree`` over the world, this rank's leaf its row
    of the operands: without noise, and with stochastic rounding."""
    import torch
    import torch.distributed as dist

    from repro_torch.optim import compressed_psum_tree
    g = compress_operands()
    r = dist.get_rank()
    leaf = torch.from_numpy(g[r % g.shape[0]]).to(device)
    exact = compressed_psum_tree({"g": leaf})["g"]
    gen = torch.Generator(device=device)
    gen.manual_seed(r)
    noisy = compressed_psum_tree({"g": leaf}, generator=gen)["g"]
    return {"exact": exact.cpu().numpy(), "noisy": noisy.cpu().numpy(),
            "world": dist.get_world_size()}


def _two_axes_case(ref, device):
    """Two mesh axes on one dimension: rows 0-7 placed with ``("pod",
    "data")`` on a 2 x 2 (pod, data) mesh; this rank's rows and its
    mesh coordinates."""
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import Rules, ShardingPlan
    mesh = make_mesh((2, 2), ("pod", "data"), device)
    plan = ShardingPlan(mesh=mesh, rules=Rules((("batch", ("pod",
                                                          "data")),)))
    x = torch.arange(16, device=device).reshape(8, 2)
    return {"rows": plan.place(x, ("batch", None)).to_local().cpu().numpy(),
            "coords": tuple(mesh.get_coordinate())}


def _elastic_case(ref, device):
    """The reference's TestElastic on this world: two ``current()``
    calls without a change."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import MEGATRON_RULES
    from repro_torch.runtime import ElasticController

    def mk(n):
        d = max(n // 2, 1)
        return make_mesh((d, 2 if n >= 2 else 1), ("data", "model"),
                         device)

    ec = ElasticController(mk, lambda shape: MEGATRON_RULES)
    mesh1, plan1, ch1 = ec.current()
    mesh2, plan2, ch2 = ec.current()
    return {"changed": (ch1, ch2), "generation": ec.generation,
            "shape": tuple(int(s) for s in mesh1.mesh.shape),
            "batch_rule": plan2.rules.get("batch"),
            "plan_mesh": plan1.mesh is mesh1}


# ---------------------------------------------------------------------
# the card's cases (chip_smoke.py's phase 15, tests/test_torch_card.py's
# TestMeshLM): ranks sharing cuda:0 over gloo
# ---------------------------------------------------------------------
#: (a): TinyLlama-1.1B at full width on {data: 2, model: 2}, its prompts
#: prefilled one at a time (batch 1, as the serving loop admits them),
#: then decode steps over 4 slots at their own positions
CARD_MESH = ((2, 2), ("data", "model"))
CARD_ARCH = "tinyllama-1.1b"
CARD_PROMPTS = (7, 64, 200, 512)
#: the assignment select_rules must pick on the card's meshes
CARD_ASSIGNMENT = {"embed": "embed:rep", "attn": "attn:heads",
                   "ffn": "ffn:tp", "stream": "stream:rep",
                   "head": "head:vocab"}
#: (c): one Jamba-v0.1 MoE layer at full width through the all-to-all
#: schedule on {model: 2}: 2 x 256 tokens, 256 on each rank, and a
#: capacity factor (8) at which no pair drops (C >= the tokens), so it
#: and the single-device gather dispatch compute one function
CARD_MOE = dict(arch="jamba-v0.1-52b", shape=(2, 256), capacity_factor=8.0,
                seed=5, scale=None)
#: (d): the compressed all-reduce over the 4 ranks of (a)'s world
CARD_COMPRESS_SHAPE = (1024, 512)


def card_config(n_layers):
    from repro_torch.configs import get_config
    return get_config(CARD_ARCH).scaled_down(
        **{k: getattr(get_config(CARD_ARCH), k) for k in (
            "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
            "vocab")}, n_layers=n_layers, name=CARD_ARCH)


def card_requests(cfg, prompts, steps):
    """numpy: each prompt's tokens, and each decode step's (4, 1)
    tokens."""
    rng = np.random.default_rng(11)
    toks = [rng.integers(0, cfg.vocab, (1, t)).astype(np.int64)
            for t in prompts]
    dec = [rng.integers(0, cfg.vocab, (len(prompts), 1)).astype(np.int64)
           for _ in range(steps)]
    return toks, dec


def insert_slot(cache, slot, pre):
    """``cache[:, slot] = pre[:, 0]`` for every leaf (a prefilled
    request's whole ``max_seq`` row into its slot, as the serving loop
    writes it); on a mesh each rank writes its own shard."""
    from repro_torch.models.sharding import local_bounds
    for lk, leaf in cache.items():
        for name, dst in leaf.items():
            src = pre[lk][name]
            if not hasattr(dst, "device_mesh"):
                dst[:, slot] = src[:, 0]
                continue
            from torch.distributed.tensor import Replicate
            pl = tuple(Replicate() if p.is_shard(1) else p
                       for p in dst.placements)
            srcl = src.redistribute(dst.device_mesh, pl).to_local()
            lo, hi = local_bounds(dst)[1]
            if lo <= slot < hi:
                dst.to_local()[:, slot - lo] = srcl[:, 0]


def serve_card(cfg, params, plan, prompts, dec, device, max_seq, rt,
               counts=None, dtype=None):
    """Prefill each prompt (batch 1), fill 4 slots, then the decode
    steps (``drop_free``, one position per slot).  Returns (logits as
    numpy: ``prefill<i>``, ``dec<s>``; host-clock ms of each call).
    ``counts`` (a dict) gets each call's launch counts, read from 0."""
    import time

    import torch

    from repro_torch import models as T
    from repro_torch.kernels.common import launch_counts, reset_launch_counts

    def full(x):
        x = x.full_tensor() if hasattr(x, "full_tensor") else x
        return x.detach().float().cpu().numpy()

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    def timed(name, fn):
        sync()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        sync()
        ms[name] = (time.perf_counter() - t0) * 1e3
        if counts is not None:
            counts[name] = launch_counts()
        return out

    out, ms = {}, {}
    cache = T.init_cache(cfg, len(prompts), max_seq,
                         dtype or torch.float32, device, plan)
    with torch.no_grad():
        for i, tok in enumerate(prompts):
            batch = {"tokens": plan.place(torch.from_numpy(tok).to(device),
                                          ("batch", "seq"))}
            logits, pre = timed(f"prefill{i}", lambda: T.prefill(
                cfg, params, batch, plan, rt, max_seq=max_seq))
            out[f"prefill{i}"] = full(logits)
            insert_slot(cache, i, pre)
            del pre
        pos = torch.tensor([t.shape[1] for t in prompts], device=device)
        for s, tok in enumerate(dec):
            t_ = plan.place(torch.from_numpy(tok).to(device),
                            ("batch", "seq"))
            logits, cache = timed(f"dec{s}", lambda: T.decode_step(
                cfg, params, cache, t_, pos + s, plan, rt, drop_free=True))
            out[f"dec{s}"] = full(logits)
    return out, ms


def card_lm_world(n_layers, steps, work_dir, device="cuda",
                  prompts=CARD_PROMPTS, train=None):
    """This rank of (a) (and (b), (d)) on {data: 2, model: 2}: the
    rules the port's ``select_rules`` picks on this mesh (H100 figures),
    TinyLlama at ``n_layers`` served by :func:`serve_card` with K6 in
    every prefill (each call's launches read on this rank), its logits
    held by the caller against the single-device run in
    ``work_dir/single.npz``; then (d) the compressed all-reduce; then,
    with ``train = (layers, seq, batch)``, (b): the loss and gradients
    of one ``train_step`` (``attn_impl="xla"``) at that depth, rank 0
    saving the full gradients to ``work_dir/grads.pt``."""
    import dataclasses
    import os

    import torch
    import torch.distributed as dist

    from repro_torch import models as T
    from repro_torch.configs import SHAPES
    from repro_torch.core.sharding_select import select_rules
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(*CARD_MESH, device)
    cfg = card_config(n_layers)
    max_seq = max(prompts) + steps + 1
    res = {"rank": dist.get_rank()}
    rep = {}
    for kind, (b, t) in (("prefill", (1, max(prompts))),
                         ("decode", (len(prompts), max_seq))):
        shp = dataclasses.replace(SHAPES["train_4k"], name=kind, kind=kind,
                                  seq_len=t, global_batch=b)
        rules, rep[kind] = select_rules(cfg, shp, dict(zip(CARD_MESH[1],
                                                           CARD_MESH[0])))
    res["assignment"] = {k: v["assignment"] for k, v in rep.items()}
    plan = T.ShardingPlan(mesh=mesh, rules=rules.restrict(CARD_MESH[1]))
    res["rules"] = dict(plan.rules.table)
    params = T.init_params(cfg, 0, torch.float32, device, plan)
    toks, dec = card_requests(cfg, prompts, steps)
    counts = {}
    out, ms = serve_card(cfg, params, plan, toks, dec, device, max_seq,
                         T.ModelRuntime(attn_impl="flash"), counts)
    del params
    with np.load(os.path.join(work_dir, "single.npz")) as z, \
            np.load(os.path.join(work_dir, "f64.npz")) as z64:
        res["dist"] = {k: rel_dist(v, z[k]) for k, v in out.items()}
        res["dist64"] = {k: rel_dist(v, z64[k]) for k, v in out.items()}
        res["single64"] = {k: rel_dist(z[k], z64[k]) for k in out}
    res["counts"], res["ms"] = counts, ms
    res["local_heads"] = (cfg.n_heads // 2, cfg.n_kv_heads // 2)
    # (d)
    g = np.random.default_rng(7).normal(
        size=(dist.get_world_size(),) + CARD_COMPRESS_SHAPE).astype(
            np.float32)
    from repro_torch.optim import compressed_psum_tree
    got = compressed_psum_tree({"g": torch.from_numpy(
        g[dist.get_rank()]).to(device)})["g"]
    res["compress"] = got.cpu().numpy()
    if train is not None:
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        res["train"] = _card_train(train, plan.rules, mesh, device,
                                   work_dir)
    return res


def card_single(n_layers, steps, work_dir, device="cuda",
                prompts=CARD_PROMPTS):
    """(a)'s single-device runs (this process alone on the card): the
    f32 flash run, and the same parameters evaluated in float64 (the
    plain attention path; every ``Tensor.float`` cast made a float64
    one for the call, RoPE's tables f32 as in every run), their logits
    saved to ``work_dir/single.npz`` and ``work_dir/f64.npz`` for the
    ranks.  Returns the f32 run's host-clock ms of each call."""
    import os

    import torch

    from repro_torch import models as T
    cfg = card_config(n_layers)
    params = T.init_params(cfg, 0, torch.float32, device)
    toks, dec = card_requests(cfg, prompts, steps)
    max_seq = max(prompts) + steps + 1
    out, ms = serve_card(cfg, params, T.ShardingPlan(), toks, dec, device,
                         max_seq, T.ModelRuntime(attn_impl="flash"))
    np.savez(os.path.join(work_dir, "single.npz"), **out)
    p64 = {}
    stack = [(params, p64)]
    while stack:
        src, dst = stack.pop()
        for k, v in src.items():
            if isinstance(v, dict):
                dst[k] = {}
                stack.append((v, dst[k]))
            else:
                dst[k] = v.double()
    del params
    real = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **kw: self.double()
    try:
        out64, _ = serve_card(cfg, p64, T.ShardingPlan(), toks, dec,
                              device, max_seq, T.ModelRuntime(), None,
                              dtype=torch.float64)
    finally:
        torch.Tensor.float = real
    np.savez(os.path.join(work_dir, "f64.npz"), **out64)
    del p64
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return ms


def check_card_lm(ranks, n_layers, device="cuda", rel=REL):
    """(a)'s gates on every rank: ``select_rules`` picked
    :data:`CARD_ASSIGNMENT` (and the batch-sharded cache at decode);
    every call's logits within ``rel`` of the single-device f32 run's
    largest, or, where the random weights amplify f32 rounding past it
    (22 layers do: each row-parallel sum over 2 ranks rounds in another
    order), no farther from the float64 evaluation than ``rel`` or
    twice the single-device f32 run is (the rule of phases 12 and 13c);
    K6 ``n_layers`` times per prefill on the card (none on the CPU,
    where the wrapper runs its plain version), never in decode.
    Returns the worst distance from the single-device run."""
    want = {"flash_attention": n_layers} if device == "cuda" else {}
    for res in ranks:
        assert res["assignment"]["prefill"] == CARD_ASSIGNMENT, res
        assert res["assignment"]["decode"] == dict(
            CARD_ASSIGNMENT, cache="cache:batch"), res
        for call, counts in res["counts"].items():
            exp = want if call.startswith("prefill") else {}
            assert counts == exp, (res["rank"], call, counts, exp)
        for k, d in res["dist"].items():
            assert d <= rel or res["dist64"][k] <= max(
                rel, 2 * res["single64"][k]), (
                res["rank"], k, d, res["dist64"][k], res["single64"][k])
    return max(max(r["dist"].values()) for r in ranks)


def compress_cpu(world):
    """(d)'s expected result: the quantised mean computed on the CPU."""
    import torch
    g = torch.from_numpy(np.random.default_rng(7).normal(
        size=(world,) + CARD_COMPRESS_SHAPE).astype(np.float32))
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8).to(
        torch.int32).sum(0)
    return (q.float() * scale / world).numpy()


def check_card_compress(ranks):
    """(d): every rank's result within 1e-6 of the largest magnitude of
    the CPU's arithmetic.  Returns the worst distance."""
    want = compress_cpu(len(ranks))
    worst = max(rel_dist(r["compress"], want) for r in ranks)
    assert worst <= 1e-6, worst
    return worst


def check_card_moe(res, rel):
    """(c): rank 0's all-to-all output finite and within ``rel`` of the
    single-device ``moe_ffn``'s largest magnitude, at capacities where no
    pair drops."""
    m0 = next(r for r in res if r["rank"] == 0)
    assert m0["finite"] and m0["dist"] <= rel, m0
    assert m0["c"] >= m0["n_local"] and m0["single_c"] >= 2 * m0["n_local"]
    return m0


def card_train_inputs(layers, seq, batch):
    """(b)'s config and batch (numpy tokens and labels)."""
    cfg = card_config(layers)
    rng = np.random.default_rng(13)
    toks = rng.integers(0, cfg.vocab, (batch, seq + 1)).astype(np.int64)
    return cfg, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _card_train(train, rules, mesh, device, work_dir):
    """(b) on this rank: ``loss_and_grads`` and one ``train_step`` of the
    model at ``train = (layers, seq, batch)`` from seed 0."""
    import os

    import torch
    import torch.distributed as dist

    from repro_torch import models as T
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.runtime.train_loop import loss_and_grads, train_step
    from repro_torch.tree import leaves, unflatten
    cfg, batch_np = card_train_inputs(*train)
    plan = T.ShardingPlan(mesh=mesh, rules=rules)
    rt = T.ModelRuntime(attn_impl="xla")
    params = T.init_params(cfg, 0, torch.float32, device, plan)
    batch = {k: plan.place(torch.from_numpy(v).to(device), ("batch", "seq"))
             for k, v in batch_np.items()}
    loss, grads = loss_and_grads(cfg, plan, rt, params, batch)
    full = [g.full_tensor().cpu() for g in leaves(grads)]
    if dist.get_rank() == 0:
        torch.save(unflatten(grads, full), os.path.join(work_dir,
                                                        "grads.pt"))
    opt = adamw(warmup_cosine(1e-3, 1, 10))
    with plan.region():
        state = opt.init(params)
    loss2, new_p, _ = train_step(cfg, opt, plan, rt, params, state, batch)
    finite = all(bool(torch.isfinite(p.full_tensor()).all())
                 for p in leaves(new_p))
    return {"loss": float(loss.full_tensor()),
            "step_loss": float(loss2.full_tensor()), "finite": finite,
            "placements": str(leaves(new_p)[0].placements)}


def card_moe_world(work_dir, device="cuda", spec=CARD_MOE):
    """(c) on this rank of {model: 2}: one Jamba-v0.1 MoE layer at full
    width, its weights drawn from ``CARD_MOE['seed']`` (each rank draws
    the whole leaf and keeps its experts), through ``moe_ffn_alltoall``
    on the rank's 256 tokens; rank 0 then runs the single-device
    ``moe_ffn`` (the gather dispatch) on all of them.  Returns the
    output's distance from it (rank 0), the all-to-all's message bytes,
    and host-clock ms.  ``spec``: :data:`CARD_MOE`, or a copy whose
    ``scale`` (``scaled_down`` overrides) shrinks the configuration."""
    import dataclasses
    import time

    import torch
    import torch.distributed as dist

    from repro_torch import models as T
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe

    cfg = get_config(spec["arch"])
    if spec["scale"]:
        cfg = cfg.scaled_down(**spec["scale"])
    cfg = dataclasses.replace(cfg, capacity_factor=spec["capacity_factor"])
    mesh = make_mesh((2,), ("model",), device)
    plan = T.ShardingPlan(mesh=mesh, rules=T.MEGATRON_RULES.restrict(
        ("model",)))
    defs = moe.moe_defs(cfg)

    def weights(place):
        """Every leaf drawn whole from one seeded generator, then
        ``place``d (one whole leaf alive at a time)."""
        gen = torch.Generator(device=device)
        gen.manual_seed(spec["seed"])
        out = {}
        for name in sorted(defs):
            d = defs[name]
            out[name] = place(torch.randn(d.shape, generator=gen,
                                          device=device)
                              * d.shape[0] ** -0.5, d.axes)
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
        return out
    p = weights(plan.place)
    x_np = np.random.default_rng(spec["seed"]).normal(
        size=spec["shape"] + (cfg.d_model,)).astype(np.float32)
    x = plan.place(torch.from_numpy(x_np).to(device),
                   ("batch", "seq", "d_model"))
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" \
        else (lambda: None)
    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        y = moe.moe_ffn_alltoall(cfg, p, x, plan)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        y = y.full_tensor()
    n_local = spec["shape"][0] * spec["shape"][1] // 2
    c = moe.capacity(cfg, n_local)
    res = {"rank": dist.get_rank(), "ms": ms, "n_local": n_local, "c": c,
           "cfg": f"{cfg.name} ({cfg.n_experts} experts top-{cfg.top_k}, "
                  f"d_model {cfg.d_model}, d_ff {cfg.d_ff})",
           "a2a_bytes": 2 * (cfg.n_experts // 2) * c * cfg.d_model * 4}
    del p
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    if dist.get_rank() == 0:   # the same draws, whole, on one device
        full = weights(lambda t, axes: t)
        with torch.no_grad():
            want = moe.moe_ffn(cfg, full, torch.from_numpy(x_np).to(device),
                               T.ShardingPlan())
        n = x_np.shape[0] * x_np.shape[1]
        res["single_c"] = moe.capacity(cfg, n)
        res["dist"] = rel_dist(y.cpu().numpy(), want.cpu().numpy())
        res["finite"] = bool(torch.isfinite(y).all())
    return res


# ---------------------------------------------------------------------
# the reference's side: one subprocess per test file
# ---------------------------------------------------------------------
REF_SCRIPT = """
import numpy as np, jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
import _torch_mesh_lm_cases as C
from repro import models as R
from repro.models import moe as RM
from repro.configs import get_config
from repro.launch.mesh import make_mesh_compat
from repro.optim import compressed_psum_tree
out = {}
def run(cfg, params, plan, rt, what, batch, steps):
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    o = {}
    if what == 'loss':
        o['loss'] = jax.jit(lambda p, b: R.loss_fn(cfg, p, b, plan, rt))(
            params, b)
        return o
    if what in ('forward', 'forward_prefill'):
        o['fwd'] = jax.jit(lambda p, b: R.forward_train(
            cfg, p, b, plan, rt))(params, b)
        if what == 'forward':
            return o
    ms = C.MAX_SEQ + (cfg.n_patches or 0)
    lg, cache = jax.jit(lambda p, b: R.prefill(cfg, p, b, plan, rt,
                                               max_seq=ms))(params, b)
    o['prefill'] = lg
    if what == 'forward_prefill':
        return o
    pos = C.T_PROMPT + (cfg.n_patches or 0)
    dec = jax.jit(lambda p, c, t, i: R.decode_step(cfg, p, c, t, i, plan,
                                                   rt))
    for s, tok in enumerate(steps):
        lg, cache = dec(params, cache, jnp.asarray(tok), jnp.int32(pos + s))
        o[f'dec{s}'] = lg
    return o
for name, (arch, kw, mshape, axes, rules, what, rt_kw, seed) in \\
        C.LM_CASES.items():
    cfg = get_config(arch).scaled_down(**kw)
    mesh = make_mesh_compat(mshape, axes)
    plan = R.ShardingPlan(mesh=mesh, rules=C.lm_rules(
        R.MEGATRON_RULES, rules).restrict(axes))
    rt = R.ModelRuntime(**rt_kw)
    params = R.init_params(cfg, jax.random.key(seed), jnp.float32)
    for k, v in C.flatten(params, name + '/params/').items():
        out[k] = v
    batch, steps = C.lm_inputs(cfg, what)
    with mesh:
        o = run(cfg, params, plan, rt, what, batch, steps)
    for k, v in o.items():
        out[name + '/' + k] = np.asarray(v)
# the all-to-all MoE: the reference's shard_map schedule on the same slabs
cfg = get_config(C.A2A['arch']).scaled_down(**C.A2A['kw'])
p = R.init_params(cfg, jax.random.key(2), jnp.float32)
p = p['blocks']['layer0']['moe']
p = {k: v[0] for k, v in p.items()}
p['router'] = p['router'].at[:, :2].add(C.A2A['skew'])
for k, v in p.items():
    out['alltoall/params/' + k] = np.asarray(v)
x = jnp.asarray(C.a2a_operands())
mesh = make_mesh_compat((2, 2), ('data', 'model'))
plan = R.ShardingPlan(mesh=mesh, rules=R.MEGATRON_RULES.restrict(
    ('data', 'model')))
with mesh:
    out['alltoall/y'] = np.asarray(jax.jit(
        lambda p, x: RM.moe_ffn_alltoall(cfg, p, x, plan))(p, x))
bl, tl = x.shape[0] // 2, x.shape[1] // 2
c = RM.capacity(cfg, bl * tl)
for d in range(2):
    for m in range(2):
        xf = x[d * bl:(d + 1) * bl, m * tl:(m + 1) * tl]
        xf = xf.reshape(-1, x.shape[-1])
        _, meta = RM._local_dispatch(cfg, {'router': p['router']}, xf, c)
        out[f'alltoall/keep{2 * d + m}'] = np.asarray(meta[0])
# two mesh axes on one dimension: each device's rows
from jax.sharding import NamedSharding
mesh = make_mesh_compat((2, 2), ('pod', 'data'))
arr = jax.device_put(np.arange(16).reshape(8, 2),
                     NamedSharding(mesh, P(('pod', 'data'), None)))
for p_ in range(2):
    for d_ in range(2):
        dev = mesh.devices[p_, d_]
        out[f'two_axes/{p_}{d_}'] = np.asarray(next(
            sh.data for sh in arr.addressable_shards if sh.device == dev))
# the compressed all-reduce, without noise
g = jnp.asarray(C.compress_operands())
mesh = make_mesh_compat((C.COMPRESS['world'],), ('pod',))
out['compress/exact'] = np.asarray(shard_map(
    lambda gl: compressed_psum_tree({'g': gl[0]}, 'pod')['g'], mesh=mesh,
    in_specs=P('pod'), out_specs=P())(g))
"""


def reference(out_dir: pathlib.Path, timeout: int = 900) -> str:
    """Run :data:`REF_SCRIPT` in one subprocess on 8 fake CPU devices;
    returns the path of its ``.npz``."""
    path = str(out_dir / "ref_lm.npz")
    code = REF_SCRIPT + textwrap.dedent(f"""
        np.savez({path!r}, **out)
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
    return path


def rel_dist(got, want) -> float:
    """Largest difference over the largest magnitude of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
