"""Architecture config registry: ``get_config(arch_id)``.

One module per assigned architecture with the exact published
configuration, plus the paper's own CNNs (see repro/convnets/).
"""
from __future__ import annotations

from .base import SHAPES, ModelConfig, ShapeConfig
from .mistral_nemo_12b import CONFIG as mistral_nemo_12b
from .command_r_35b import CONFIG as command_r_35b
from .tinyllama_1_1b import CONFIG as tinyllama_1_1b
from .gemma2_9b import CONFIG as gemma2_9b
from .whisper_large_v3 import CONFIG as whisper_large_v3
from .kimi_k2_1t_a32b import CONFIG as kimi_k2_1t_a32b
from .grok_1_314b import CONFIG as grok_1_314b
from .llava_next_34b import CONFIG as llava_next_34b
from .jamba_v0_1_52b import CONFIG as jamba_v0_1_52b
from .mamba2_2_7b import CONFIG as mamba2_2_7b

ARCHS = {
    c.name: c for c in [
        mistral_nemo_12b, command_r_35b, tinyllama_1_1b, gemma2_9b,
        whisper_large_v3, kimi_k2_1t_a32b, grok_1_314b, llava_next_34b,
        jamba_v0_1_52b, mamba2_2_7b,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {list(ARCHS)}")
    return ARCHS[name]


def cells():
    """All (arch, shape) dry-run cells, with inapplicable ones marked."""
    out = []
    for aname, cfg in ARCHS.items():
        for sname, shp in SHAPES.items():
            skip = None
            if sname == "long_500k" and not cfg.sub_quadratic:
                skip = "long_500k needs sub-quadratic attention " \
                       "(pure full-attention arch) — see docs/distributed.md"
            out.append((aname, sname, skip))
    return out


__all__ = ["ARCHS", "SHAPES", "get_config", "cells", "ModelConfig",
           "ShapeConfig"]
