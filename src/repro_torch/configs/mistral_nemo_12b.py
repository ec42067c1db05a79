"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407].

Dense decoder, 40L, d_model 5120, 32 heads / 8 KV (GQA), d_ff 14336,
vocab 131072, head_dim 128, 128k context.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=131072,
    head_dim=128,
    rope_theta=1e6,
    sub_quadratic=False,
    source="hf:mistralai/Mistral-Nemo-Base-2407",
)
