"""TinyLlama-1.1B [arXiv:2401.02385] — llama2-architecture small model.

22L, d_model 2048, 32 heads / 4 KV (GQA), d_ff 5632, vocab 32000.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab=32000,
    head_dim=64,
    rope_theta=1e4,
    sub_quadratic=False,
    source="arXiv:2401.02385",
)
