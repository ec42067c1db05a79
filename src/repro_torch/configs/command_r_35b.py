"""Cohere Command-R 35B [hf:CohereForAI/c4ai-command-r-v01].

Dense decoder, 40L, d_model 8192, 64 heads / 8 KV (GQA), d_ff 22528,
vocab 256000, no biases.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256000,
    head_dim=128,
    rope_theta=8e6,
    tie_embeddings=True,
    parallel_block=True,
    sub_quadratic=False,
    source="hf:CohereForAI/c4ai-command-r-v01",
)
