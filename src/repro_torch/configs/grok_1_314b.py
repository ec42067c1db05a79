"""Grok-1 314B [hf:xai-org/grok-1] — 8-expert top-2 MoE.

64L, d_model 6144, 48 heads / 8 KV, d_ff 32768, vocab 131072.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    head_dim=128,
    n_experts=8,
    top_k=2,
    moe_every=1,
    sub_quadratic=False,
    source="hf:xai-org/grok-1",
)
