"""Jamba v0.1 52B [arXiv:2403.19887] — Mamba + attention hybrid MoE.

32 blocks, d_model 4096, 32 heads / 8 KV, d_ff 14336, vocab 65536.
1 attention layer per 8 blocks (1:7 attn:mamba), MoE (16 experts,
top-2) every other block.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    head_dim=128,
    n_experts=16,
    top_k=2,
    moe_every=2,
    attn_every=8,            # block index 4 of each 8-block period (attn)
    ssm_state=16,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv=4,
    sub_quadratic=True,
    source="arXiv:2403.19887",
)
