"""Fault-tolerant training loop (port of the reference's
``runtime/train_loop.py``: the same retry, restore and cold re-init
logic and the same ``metrics_out`` records).

* checkpoint/restart — atomic checkpoints every N steps; on (re)start
  the loop restores the latest checkpoint and replays the data pipeline
  from the step counter (deterministic data, so a resumed run follows
  the uninterrupted one).
* failure handling — a step that raises (device OOM, injected fault,
  preempted host) or gives a non-finite loss triggers
  restore-from-last-checkpoint + re-execution; after ``max_retries``
  consecutive failures the loop aborts.
* straggler mitigation — per-step wall times feed an EWMA; steps slower
  than ``straggler_factor`` x EWMA are logged and counted, and a
  callback can re-shard/evict.

A step differentiates ``loss_fn`` with ``torch.autograd.grad`` over the
parameters (nothing accumulates into ``.grad``, so a step that raises
leaves no gradient behind) and applies the optimizer's functional
update, in true f32 (TF32 off, as the reference computes).  The loss is
read to the host once per step: that read is the step's one sync, so
the straggler clock measures the device's time.

The reference's ``pod_sync_every`` (DiLoCo-style multi-pod sync) is
declared there but read nowhere; it is left out here.  The default
checkpoint directory is the port's own (``repro_torch_ckpt`` under
``tempfile.gettempdir()``, which honours ``TMPDIR``), so the two
packages never resume each other's runs by accident.
"""
from __future__ import annotations

import math
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch

from ..checkpoint import Checkpointer
from ..data.pipeline import make_batch
from ..kernels.common import resolve_device, true_f32
from ..models import ModelRuntime, ShardingPlan, init_params, loss_fn
from ..optim.optimizers import Optimizer
from ..tree import leaves as _leaves
from ..tree import unflatten as _unflatten

__all__ = ["TrainLoopConfig", "train", "train_step", "loss_and_grads",
           "TrainState", "StragglerMonitor"]


@dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep: int = 3
    max_retries: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10


@dataclass
class TrainState:
    step: int
    params: Any
    opt_state: Any


class StragglerMonitor:
    def __init__(self, factor: float = 3.0, alpha: float = 0.2):
        self.factor = factor
        self.alpha = alpha
        self.ewma: Optional[float] = None
        self.stragglers: List[int] = []

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = (self.ewma is not None and
                        dt > self.factor * self.ewma)
        if is_straggler:
            self.stragglers.append(step)
        # slow samples shouldn't poison the baseline
        w = self.alpha if not is_straggler else self.alpha * 0.1
        self.ewma = dt if self.ewma is None else \
            (1 - w) * self.ewma + w * dt
        return is_straggler


def loss_and_grads(cfg, plan: ShardingPlan, rt: ModelRuntime, params,
                   batch):
    """``loss_fn`` and its gradients, in true f32: (the loss on the
    device, the gradients in ``params``' structure).  A parameter the loss
    does not reach gets a zero gradient, as ``jax.grad`` gives it.
    ``params`` are left as they were.  On a mesh (DTensor parameters)
    the backward pass runs in ``plan.region()`` too, and each gradient
    takes its parameter's placements (a partial sum over the data axes
    is all-reduced: the data-parallel gradient reduction)."""
    with true_f32():
        leaves = [p.detach().requires_grad_() for p in _leaves(params)]
        with torch.enable_grad(), plan.region():
            loss = loss_fn(cfg, _unflatten(params, leaves), batch, plan, rt)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else
             g.redistribute(p.device_mesh, p.placements)
             if hasattr(g, "redistribute") else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), _unflatten(params, grads)


def train_step(cfg, opt: Optimizer, plan: ShardingPlan, rt: ModelRuntime,
               params, opt_state, batch):
    """One step of :func:`train`: (loss on the device, new params, new
    optimizer state).  The inputs are left as they were."""
    loss, grads = loss_and_grads(cfg, plan, rt, params, batch)
    with true_f32():
        new_p, new_s = opt.update(grads, opt_state, params)
    return loss, new_p, new_s


def train(cfg, shape, opt: Optimizer, *, plan: Optional[ShardingPlan] = None,
          rt: ModelRuntime = ModelRuntime(), loop: TrainLoopConfig =
          TrainLoopConfig(), seed: int = 0, dtype=torch.float32,
          fault_hook: Optional[Callable[[int], None]] = None,
          on_straggler: Optional[Callable[[int, float], None]] = None,
          metrics_out: Optional[List[Dict]] = None,
          device=None) -> TrainState:
    """Run (or resume) training on ``device`` (the card unless told
    otherwise); returns the final state.

    ``fault_hook(step)`` may raise to simulate node failures (tests).
    A cold start draws the port's own ``init_params`` from ``seed``
    (not the reference's values: resume from a checkpoint to start where
    the reference starts).
    """
    dev = resolve_device(device)
    plan = plan or ShardingPlan(mesh=None)
    ckpt = Checkpointer(loop.ckpt_dir, keep=loop.keep)

    params = init_params(cfg, seed, dtype, dev)
    opt_state = opt.init(params)
    start_step = 0
    latest = ckpt.latest_step()
    if latest is not None:
        start_step, (params, opt_state), _ = ckpt.restore(
            (params, opt_state))
        print(f"[train] resumed from checkpoint step {start_step}")

    monitor = StragglerMonitor(loop.straggler_factor)
    retries = 0
    step = start_step
    while step < loop.total_steps:
        batch = make_batch(cfg, shape, step, seed=seed, dtype=dtype,
                           device=dev)
        t0 = time.perf_counter()
        try:
            if fault_hook is not None:
                fault_hook(step)
            loss, params, opt_state = train_step(cfg, opt, plan, rt,
                                                 params, opt_state, batch)
            loss = float(loss)
            if not math.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at {step}")
        except Exception as e:  # noqa: BLE001 — any failure: restore
            retries += 1
            print(f"[train] step {step} failed ({e!r}); "
                  f"retry {retries}/{loop.max_retries}")
            if retries > loop.max_retries:
                raise RuntimeError(
                    f"aborting after {retries} consecutive failures") from e
            latest = ckpt.latest_step()
            if latest is not None:
                step, (params, opt_state), _ = ckpt.restore(
                    (params, opt_state))
                print(f"[train] restored step {step}")
            else:
                # no checkpoint yet: re-init (cold restart)
                params = init_params(cfg, seed, dtype, dev)
                opt_state = opt.init(params)
                step = 0
            continue

        retries = 0
        dt = time.perf_counter() - t0
        if monitor.observe(step, dt) and on_straggler is not None:
            on_straggler(step, dt)
        if metrics_out is not None:
            metrics_out.append({"step": step, "loss": loss, "time_s": dt})
        if loop.log_every and step % loop.log_every == 0:
            print(f"[train] step {step} loss {loss:.4f} ({dt*1e3:.0f} ms)")
        step += 1
        if step % loop.ckpt_every == 0 or step == loop.total_steps:
            ckpt.save(step, (params, opt_state),
                      extra={"loss": loss})

    return TrainState(step, params, opt_state)
