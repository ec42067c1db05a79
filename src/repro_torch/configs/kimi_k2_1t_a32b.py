"""Kimi K2 1T-A32B [arXiv:2501.kimi2] — trillion-parameter MoE.

61L, d_model 7168, 64 heads / 8 KV, expert d_ff 2048, vocab 163840,
MoE with 384 experts, top-8 routing (paper-table config).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,              # per-expert FFN width
    vocab=163840,
    head_dim=112,           # 64 * 112 = 7168
    n_experts=384,
    top_k=8,
    moe_every=1,
    sub_quadratic=False,
    source="arXiv:2501.kimi2",
)
