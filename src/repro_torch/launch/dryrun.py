"""Dry-run on a fake process group: every (arch x shape x mesh) cell's
step traced on the production mesh, with no device and no storage.

Port of the reference's ``launch/dryrun.py`` (which lowers and compiles
every cell for 512 fake XLA devices).  Per cell:

  1. a ``"fake"`` process group of 256 (16x16 single pod) or 512
     (2x16x16 two-pod) ranks in this one process, and the production
     mesh over it (``launch.mesh.make_production_mesh``);
  2. the sharding PBQP (``core.sharding_select.select_rules``, priced
     with ``H100_SPEC``) -> Rules, or ``--rules megatron``;
  3. parameters, optimizer state and inputs as meta-tensor DTensors
     placed by the rules (``ShardingPlan.place``), then the cell's step
     run once: train (loss, backward and the ``for_config`` optimizer's
     update), prefill, or decode;
  4. per device (rank 0's view; the fake group's collectives move
     nothing): the collectives the step issued, counts and operand bytes
     by kind, read at the dispatcher from the functional collectives
     DTensor and the all-to-all MoE call; the flops of this rank's local
     ops (``torch.utils.flop_counter``'s formulas, DTensor's own
     shape-propagation calls left out); the argument bytes of the local
     shards of parameters, optimizer state and inputs; and, as the
     reference records them, ``model_flops``, ``params_total``,
     ``params_active`` and the ``sharding_report``.

What has no counterpart is left out: XLA's ``temp_bytes`` and
``alias_bytes`` (no compiler buffer assignment here), ``bytes accessed``,
and the reference's unroll differencing (``_combine_unrolls``,
``parse_collectives``): the port's loops are Python loops, so the trace
sees every layer and every SSD chunk once.  DTensor chooses its own
redistributions, so the collective counts are the port's and are not
comparable with the reference's artifacts.

A failing cell writes an ``"error"`` artifact, as in the reference.
Artifacts go to ``build/repro_torch/dryrun/`` (git-ignored) unless
``--out`` says otherwise.

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
      --shape decode_32k --multi-pod
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
import traceback
from typing import Dict, Optional

import torch

ARTIFACT_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch" / "dryrun"

#: the reference's collective kinds (the port issues no
#: collective-permute), and the ops behind them: DTensor's functional
#: collectives and the all-to-all MoE's ``all_to_all_single``
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_KIND = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
         "reduce_scatter_tensor": "reduce-scatter",
         "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all"}


def _tensor_bytes(x) -> int:
    return int(x.numel()) * x.element_size()


class DeviceCounter:
    """A dispatch mode that records, for this rank, every collective
    (count and operand bytes by kind) and the flops of every local op.

    An op on DTensors is handed on (``NotImplemented``): DTensor runs it
    as local ops and functional collectives, which this mode then sees.
    DTensor's shape propagation also runs ops on global meta tensors;
    those are recognised by their caller and not counted."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        from torch.distributed.tensor import DTensor
        counter = self
        self.collectives = {c: {"count": 0, "bytes": 0} for c in COLLECTIVES}
        self.flops = 0

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **kwargs)
                pkt = func.overloadpacket
                ns = func.namespace
                if ns in ("_c10d_functional", "c10d_functional", "c10d"):
                    kind = _KIND.get(pkt.__name__)
                    if kind is not None:
                        rec = counter.collectives[kind]
                        rec["count"] += 1
                        rec["bytes"] += _tensor_bytes(args[0])
                elif pkt in flop_registry and not _in_propagation():
                    counter.flops += int(flop_registry[pkt](
                        *args, **kwargs, out_val=out))
                return out

        self._mode = _Mode()

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def _in_propagation(depth: int = 10) -> bool:
    """Whether the op was called by DTensor's sharding propagation (it
    runs ops on global meta tensors to infer shapes)."""
    f = sys._getframe(2)
    for _ in range(depth):
        if f is None:
            return False
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


def fake_world(n: int) -> None:
    """Make the default process group a ``"fake"`` one of ``n`` ranks
    (this process is rank 0; collectives move nothing)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def _local_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if hasattr(tree, "to_local"):
        tree = tree.to_local()
    return _tensor_bytes(tree) if torch.is_tensor(tree) else 0


def _place_tree(plan, specs, axes):
    if isinstance(specs, dict):
        return {k: _place_tree(plan, specs[k], axes[k]) for k in specs}
    return plan.place(specs, axes)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             rules_mode: str = "pbqp", extra_rules: Optional[Dict] = None,
             variant: Optional[Dict] = None,
             mesh_shape: Optional[Dict[str, int]] = None,
             scale: Optional[Dict] = None, shape=None) -> Dict:
    """Trace one cell's step on the production mesh and return its
    record.  For tests: ``mesh_shape`` (axis name -> size) replaces the
    production mesh with a smaller fake one, ``scale`` (``scaled_down``
    overrides) the configuration with a scaled one, and ``shape`` (a
    ``ShapeConfig``) the named shape."""
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh

    from ..configs import SHAPES, get_config
    from ..core.sharding_select import select_rules
    from ..models import (
        MEGATRON_RULES, ModelRuntime, ShardingPlan, active_param_count,
        decode_step, param_count, prefill,
    )
    from ..models.blocks import layer_kinds, n_super
    from ..models.model import param_defs, param_shapestructs
    from ..models.sharding import place_params
    from ..optim.optimizers import for_config
    from ..runtime.train_loop import loss_and_grads
    from .inputs import input_specs
    from .mesh import make_production_mesh, mesh_shape_dict

    cfg = get_config(arch)
    if scale is not None:
        cfg = cfg.scaled_down(**scale)
    if variant and "kv_heads_pad" in variant:
        # Megatron-style KV-head replication: pad GQA kv heads up to the
        # TP width so the KV projections shard instead of replicating
        variant = dict(variant)
        cfg = dataclasses.replace(
            cfg, n_kv_heads=int(variant.pop("kv_heads_pad")))
    shape = shape or SHAPES[shape_name]
    if mesh_shape is None:
        fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    else:
        n = 1
        for s in mesh_shape.values():
            n *= int(s)
        fake_world(n)
        mesh = init_device_mesh("cpu", tuple(mesh_shape.values()),
                                mesh_dim_names=tuple(mesh_shape))
    mshape = mesh_shape_dict(mesh)
    n_dev = int(mesh.mesh.numel())

    report = {}
    if rules_mode == "pbqp":
        rules, report = select_rules(cfg, shape, mshape)
    elif rules_mode == "megatron":
        rules = MEGATRON_RULES
    else:
        raise ValueError(rules_mode)
    if extra_rules:
        rules = rules.with_(**extra_rules)
    rules = rules.restrict(mesh.mesh_dim_names)
    plan = ShardingPlan(mesh=mesh, rules=rules)

    # the reference's SSD chunk for the dry-run: <= 32 chunks per
    # superblock's mamba layers
    n_mamba = sum(1 for k in layer_kinds(cfg) if k["mixer"] == "mamba")
    t_eff = shape.seq_len if shape.kind != "decode" else 1
    chunk = max(256, t_eff * max(n_mamba, 1) // 32) if t_eff > 1 else 256
    rt_kw = dict(attn_impl="xla", remat=(shape.kind == "train"),
                 chunk=chunk)
    if variant:
        rt_kw.update(variant)
    rt = ModelRuntime(**rt_kw)

    t0 = time.time()
    dtype = torch.bfloat16
    params = place_params(param_shapestructs(cfg, dtype), param_defs(cfg),
                          plan)
    specs, axes = input_specs(cfg, shape, dtype=dtype)
    inputs = _place_tree(plan, specs, axes)
    arg_bytes = {"params": _local_bytes(params),
                 "inputs": _local_bytes(inputs)}
    counter = DeviceCounter()
    if shape.kind == "train":
        opt = for_config(cfg)
        with plan.region():
            opt_state = opt.init(params)
        arg_bytes["opt_state"] = _local_bytes(opt_state)
        with counter, torch.no_grad():
            loss, grads = loss_and_grads(cfg, plan, rt, params, inputs)
            with plan.region():
                new_p, new_s = opt.update(grads, opt_state, params)
        out_bytes = _local_bytes(new_p) + _local_bytes(new_s) + \
            _local_bytes(loss)
    elif shape.kind == "prefill":
        with counter, torch.no_grad():
            logits, cache = prefill(cfg, params, inputs, plan, rt)
        out_bytes = _local_bytes(logits) + _local_bytes(cache)
    else:
        with counter, torch.no_grad():
            logits, _ = decode_step(cfg, params, inputs["cache"],
                                    inputs["tokens"], shape.seq_len - 1,
                                    plan, rt,
                                    cross_kv=inputs.get("cross_kv"))
        out_bytes = _local_bytes(logits)
    trace_s = time.time() - t0
    colls = counter.collectives

    n_tok = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                  else 1)
    n_active = active_param_count(cfg)
    mf = (6 if shape.kind == "train" else 2) * n_active * n_tok
    arg_bytes["total"] = sum(arg_bytes.values())
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(s) for s in mshape.values())
        if mesh_shape is not None else ("2x16x16" if multi_pod else "16x16"),
        "rules_mode": rules_mode,
        "variant": dict(variant) if variant else {},
        "n_devices": n_dev,
        "status": "ok",
        "flops_per_device": float(counter.flops),
        "collectives": colls,
        "collective_bytes_per_device": int(
            sum(v["bytes"] for v in colls.values())),
        "memory": {"argument_bytes": arg_bytes,
                   "output_bytes": int(out_bytes)},
        "model_flops": float(mf),
        "params_total": param_count(cfg),
        "params_active": n_active,
        "n_super": n_super(cfg),
        "sharding_report": report,
        "trace_s": trace_s,
    }


def cell_name(arch, shape_name, multi_pod, rules_mode="pbqp", tag=""):
    name = f"{arch}__{shape_name}__{'2x16x16' if multi_pod else '16x16'}"
    if rules_mode != "pbqp":
        name += f"__{rules_mode}"
    if tag:
        name += f"__{tag}"
    return name


def run_and_save(arch, shape_name, multi_pod, rules_mode="pbqp",
                 out_dir=ARTIFACT_DIR, extra_rules=None, tag="",
                 variant=None):
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    name = cell_name(arch, shape_name, multi_pod, rules_mode, tag)
    path = out_dir / f"{name}.json"
    try:
        rec = run_cell(arch, shape_name, multi_pod=multi_pod,
                       rules_mode=rules_mode, extra_rules=extra_rules,
                       variant=variant)
    except Exception as e:  # record failures as artifacts too
        rec = {"arch": arch, "shape": shape_name,
               "mesh": "2x16x16" if multi_pod else "16x16",
               "rules_mode": rules_mode, "status": "error",
               "error": repr(e), "traceback": traceback.format_exc()}
    path.write_text(json.dumps(rec, indent=2))
    return rec


def _parse_variant(text: str) -> Dict:
    variant = {}
    for kv in filter(None, text.split(",")):
        k, v = kv.split("=")
        variant[k] = v == "True" if v in ("True", "False") else v
    return variant


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--rules", default="pbqp",
                    choices=["pbqp", "megatron"])
    ap.add_argument("--out", default=str(ARTIFACT_DIR))
    ap.add_argument("--tag", default="",
                    help="artifact suffix for variant runs")
    ap.add_argument("--variant", default="",
                    help="comma list of ModelRuntime overrides, e.g. "
                         "attn_impl=xla_chunked,remat_policy=dots "
                         "(kv_heads_pad=N pads the kv heads)")
    args = ap.parse_args(argv)
    variant = _parse_variant(args.variant)
    rec = run_and_save(args.arch, args.shape, args.multi_pod, args.rules,
                       args.out, tag=args.tag, variant=variant or None)
    print(json.dumps({k: v for k, v in rec.items()
                      if k not in ("traceback",)}, indent=2))
    if rec["status"] != "ok":
        print(rec.get("traceback", ""), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
