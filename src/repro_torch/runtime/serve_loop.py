"""Batched serving loop: continuous batching over a KV-cache decode step.

Port of the reference's ``runtime/serve_loop.py``.  Requests arrive with
prompts of varying length; the loop packs up to ``max_batch`` active
sequences, prefills new arrivals into free slots, and runs one batched
decode step per tick for all slots.  Finished sequences (EOS or length
budget) free their slot immediately.

A request may carry an image (``Request.pixels``, logical C x H x W).
With a :class:`~repro_torch.serving.server.PlanServer`, the image goes
through the loop's :class:`~repro_torch.serving.scheduler.
ContinuousScheduler` to the server's PBQP-selected conv tower at
admission time (bucket lookup, cached plan, cached executable: on a card
a captured CUDA graph), and the resulting feature vector is quantized
into ``image_tokens`` pseudo-tokens prepended to the prompt.

Requests may carry an ``arrival_s`` offset, which :meth:`ServeLoop.run`
honours as an *open-loop* arrival process.

The reference decodes with ``vmap`` over the slots of a one-slot
``decode_step``; the port runs one batched step with a position per
slot (rope at each slot's position, each slot's new k/v written at its
own index in place, each slot's keys masked at its own length, the MoE
layers given a capacity of at least the slot count, since the
reference's one-slot steps never drop a pair).  An idle
slot decodes token 0 as in the reference, at its stale position clamped
into the cache (where the reference's update clamps its index); its
result is discarded and its cache row is overwritten whole at the slot's
next admission.  Prefill and the decode step run in true f32
(``kernels.common.true_f32``: TF32 off).  The loop runs on the card
unless it is given ``device="cpu"`` (then with the plain versions), and
the parameters must lie there.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..kernels.common import resolve_device, true_f32
from ..models import (
    ModelRuntime, ShardingPlan, decode_step, init_cache, prefill,
)

__all__ = ["Request", "ServeLoop"]


@dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (T,) int32
    max_new_tokens: int = 16
    eos_id: int = -1             # -1: never
    #: optional image (C, H, W) handled by the loop's PlanServer
    pixels: Optional[np.ndarray] = None
    #: open-loop arrival offset (seconds from run() start); the loop
    #: does not see the request before this
    arrival_s: float = 0.0
    # outputs
    tokens: List[int] = field(default_factory=list)
    done: bool = False
    latency_s: float = 0.0
    #: submit -> admission wait (queueing the loop itself induced)
    wait_s: float = 0.0


class ServeLoop:
    def __init__(self, cfg, params, *, max_batch: int = 4,
                 max_seq: int = 128, plan: Optional[ShardingPlan] = None,
                 rt: ModelRuntime = ModelRuntime(),
                 plan_server=None, image_tokens: int = 4,
                 scheduler=None, slo_s: Optional[float] = None,
                 elastic=None, device=None):
        #: where the loop runs (the card unless told otherwise); the
        #: parameters must lie there
        self.device = resolve_device(device)
        emb = params["embed"]
        if emb.device.type != self.device.type:
            raise ValueError(f"the parameters lie on {emb.device}; the "
                             f"loop runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.plan = plan or ShardingPlan(mesh=None)
        self.rt = rt
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.plan_server = plan_server
        self.image_tokens = image_tokens
        #: vision SLO handed to every scheduler submission (None: no
        #: deadline; requests launch on the full/window triggers only)
        self.slo_s = slo_s
        self.scheduler = scheduler
        self._owns_scheduler = False
        if scheduler is None and plan_server is not None:
            from ..serving.scheduler import ContinuousScheduler
            self.scheduler = ContinuousScheduler(
                plan_server, slo_s=slo_s, elastic=elastic)
            self._owns_scheduler = True
        self.cache = init_cache(cfg, max_batch, max_seq, emb.dtype,
                                emb.device)
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.slot_pos = np.zeros(max_batch, np.int32)
        self.queue: List[Request] = []

    # -----------------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _encode_pixels(self, req: Request, outs: Dict[str, np.ndarray]):
        """Vision-token bridge: conv-tower features -> prompt tokens.

        The tower's top activations are quantized by rank: the indices of
        the ``image_tokens`` largest features (mod vocab) become pseudo-
        tokens.  Deterministic per image, so a repeated image yields a
        repeated prefix."""
        v = np.concatenate([np.asarray(o, np.float32).ravel()
                            for o in outs.values()])
        k = min(self.image_tokens, v.size)
        toks = (np.argsort(v)[-k:][::-1] % self.cfg.vocab).astype(np.int32)
        prompt = np.asarray(req.prompt, np.int32)
        # a prompt that fit before must still fit with the vision prefix:
        # drop the oldest text tokens, never the image tokens
        budget = self.max_seq - req.max_new_tokens - 1 - k
        if budget < len(prompt):
            prompt = prompt[len(prompt) - max(budget, 0):]
        req.prompt = np.concatenate([toks, prompt])
        req.pixels = None

    def _admit(self):
        free = [s for s in range(self.max_batch)
                if self.slot_req[s] is None]
        admitted = []
        for slot in free:
            if not self.queue:
                break
            req = self.queue.pop(0)
            req._t0 = time.perf_counter()
            req.wait_s = req._t0 - getattr(req, "_t_arrived", req._t0)
            admitted.append((slot, req))
        if not admitted:
            return
        # every admitted image goes to the scheduler, which coalesces
        # co-batchable requests into in-flight bucket groups; the admit
        # span ties the tick's submissions together in the trace
        vision: Dict[int, Any] = {}
        if self.scheduler is not None:
            from concurrent.futures import Future as _Future

            from ..obs.trace import get_tracer
            from ..reliability import ShedError
            with get_tracer().span("admit", requests=len(admitted)):
                for slot, req in admitted:
                    if req.pixels is not None:
                        try:
                            vision[slot] = self.scheduler.submit(
                                req.pixels)
                        except ShedError:
                            # shed at admission: this loop cannot drop a
                            # request, so the image takes the direct
                            # unbatched path instead
                            fut: _Future = _Future()
                            fut.set_result(
                                self.plan_server.infer(req.pixels))
                            vision[slot] = fut
        for slot, req in admitted:
            if slot in vision:
                self._encode_pixels(req, vision[slot].result())
            t = len(req.prompt)
            tokens = torch.from_numpy(
                np.asarray(req.prompt, np.int64)[None]).to(self.device)
            with true_f32():
                logits, cache1 = prefill(
                    self.cfg, self.params, {"tokens": tokens},
                    self.plan, self.rt, max_seq=self.max_seq)
                # the slot's whole max_seq row, as the reference writes it
                for lk, leaf in cache1.items():
                    for name, new in leaf.items():
                        self.cache[lk][name][:, slot] = new[:, 0]
            req.tokens.append(int(torch.argmax(logits[0, -1])))
            self.slot_req[slot] = req
            self.slot_pos[slot] = t

    def _tick(self):
        tokens = np.zeros((self.max_batch, 1), np.int64)
        for s, req in enumerate(self.slot_req):
            if req is not None:
                tokens[s, 0] = req.tokens[-1]
        pos = np.minimum(self.slot_pos, self.max_seq - 1)
        with true_f32():
            logits, self.cache = decode_step(
                self.cfg, self.params, self.cache,
                torch.from_numpy(tokens).to(self.device),
                torch.from_numpy(pos.astype(np.int64)).to(self.device),
                self.plan, self.rt, drop_free=True)
        nxt_all = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            nxt = int(nxt_all[s])
            req.tokens.append(nxt)
            self.slot_pos[s] += 1
            if (len(req.tokens) >= req.max_new_tokens or
                    nxt == req.eos_id or
                    self.slot_pos[s] >= self.max_seq - 1):
                req.done = True
                req.latency_s = time.perf_counter() - req._t0
                self.slot_req[s] = None

    def run(self, requests: List[Request], max_ticks: int = 10_000
            ) -> List[Request]:
        """Serve ``requests`` to completion (open-loop arrivals).

        Requests become visible to admission only once their
        ``arrival_s`` offset has elapsed.  The default ``arrival_s=0``
        queues everything up front.
        """
        pending = sorted(requests, key=lambda r: r.arrival_s)
        t0 = time.perf_counter()
        ticks = 0
        i = 0
        while ((i < len(pending) or self.queue or any(self.slot_req))
               and ticks < max_ticks):
            now = time.perf_counter() - t0
            while i < len(pending) and pending[i].arrival_s <= now:
                req = pending[i]
                req._t_arrived = time.perf_counter()
                self.submit(req)
                i += 1
            if not self.queue and not any(self.slot_req):
                # idle until the next arrival; sleeping (not ticking)
                # keeps the wait off the tick budget
                time.sleep(max(min(pending[i].arrival_s - now, 0.005),
                               0.0))
                continue
            self._admit()
            self._tick()
            ticks += 1
        return requests

    def close(self) -> None:
        """Release the scheduler if this loop created it (drains any
        queued vision work first)."""
        if self._owns_scheduler and self.scheduler is not None:
            self.scheduler.close()
            self.scheduler = None
