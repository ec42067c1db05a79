"""Meta-tensor stand-ins for every model input (no allocation).

Port of the reference's ``launch/inputs.py``.  ``input_specs(cfg,
shape)`` returns (specs, logical_axes): the same pattern as the tests'
real batches, but as meta tensors (shapes and dtypes, no storage), with
the logical axes that place them on a mesh
(``ShardingPlan.place``): consumed by the dry-run
(:mod:`repro_torch.launch.dryrun`).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models.model import cache_axes, init_cache

__all__ = ["input_specs", "batch_axes"]


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                dtype=torch.bfloat16) -> Tuple[Dict[str, Any],
                                               Dict[str, Any]]:
    """Returns (specs, axes): a dict of meta tensors + the matching
    logical-axis tuples for sharding resolution."""
    b, t = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        t_text = t
        specs: Dict[str, Any] = {}
        axes: Dict[str, Any] = {}
        if cfg.family == "vlm":
            t_text = t - cfg.n_patches
            specs["patches"] = _meta((b, cfg.n_patches, cfg.d_model), dtype)
            axes["patches"] = ("batch", "seq", "d_model")
        if cfg.family == "encdec":
            specs["frames"] = _meta((b, cfg.enc_seq, cfg.d_model), dtype)
            axes["frames"] = ("batch", "enc_seq", "d_model")
        specs["tokens"] = _meta((b, t_text), torch.int32)
        axes["tokens"] = ("batch", "seq")
        if shape.kind == "train":
            specs["labels"] = _meta((b, t_text), torch.int32)
            axes["labels"] = ("batch", "seq")
        return specs, axes

    # decode: one new token against a seq_len KV cache
    cache = init_cache(cfg, b, t, dtype, device="meta")
    cache_ax = {lk: {name: cache_axes(name) for name in leaf}
                for lk, leaf in cache.items()}
    specs = {"cache": cache, "tokens": _meta((b, 1), torch.int32)}
    axes = {"cache": cache_ax, "tokens": ("batch", "seq")}
    if cfg.family == "encdec":
        specs["cross_kv"] = _meta((b, cfg.enc_seq, cfg.d_model), dtype)
        axes["cross_kv"] = ("batch", "enc_seq", "d_model")
    return specs, axes


def batch_axes(axes_tree, rules):
    """Resolve logical axes -> partition specs for the input tree."""
    if isinstance(axes_tree, dict):
        return {k: batch_axes(v, rules) for k, v in axes_tree.items()}
    return rules.spec(axes_tree)
