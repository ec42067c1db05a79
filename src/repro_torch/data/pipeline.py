"""Deterministic synthetic LM data pipeline (port of the reference's
``data/pipeline.py``: the same numpy draws, so both packages see the same
batches).

Produces token batches keyed by (seed, step): every host can materialise
its own shard of the global batch without coordination — the property
that makes restart-from-checkpoint exactly reproducible
(runtime/train_loop.py replays from the step counter).

A Zipfian unigram mixture with short-range induction structure (repeated
bigrams) gives the model something learnable so the example trainer's
loss visibly decreases.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..kernels.common import resolve_device

__all__ = ["SyntheticLM", "make_batch"]


def make_batch(cfg, shape, step: int, *, seed: int = 0,
               dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    """The full global batch for ``step`` on ``device`` (the card unless
    told otherwise): int32 ``tokens`` and ``labels`` (the tokens shifted
    by one), and an encoder-decoder's ``frames`` or a VLM's ``patches``
    in ``dtype``.  Drawn on the host, moved at the end."""
    dev = resolve_device(device)
    b, t = shape.global_batch, shape.seq_len
    rng = np.random.default_rng(np.uint64(seed * 1_000_003 + step))
    v = cfg.vocab
    # zipf-ish unigram over a 4k head of the vocab
    head = min(v, 4096)
    ranks = np.arange(1, head + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = rng.choice(head, size=(b, t + 1), p=probs).astype(np.int32)
    # induction structure: copy a shifted window so attention has signal
    half = t // 2
    toks[:, half:half * 2] = toks[:, :half]
    batch = {"tokens": np.ascontiguousarray(toks[:, :-1]),
             "labels": np.ascontiguousarray(toks[:, 1:])}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(b, cfg.enc_seq, cfg.d_model)) \
            * 0.02
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(size=(b, cfg.n_patches,
                                            cfg.d_model)) * 0.02
    out = {}
    for k, a in batch.items():
        x = torch.from_numpy(a)
        out[k] = (x if k in ("tokens", "labels") else x.to(dtype)).to(dev)
    return out


@dataclass
class SyntheticLM:
    """Iterator facade with prefetch-shape semantics of a real pipeline."""

    cfg: object
    shape: object
    seed: int = 0
    start_step: int = 0
    device: Optional[object] = None

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = self.start_step
        while True:
            yield make_batch(self.cfg, self.shape, step, seed=self.seed,
                             device=self.device)
            step += 1
