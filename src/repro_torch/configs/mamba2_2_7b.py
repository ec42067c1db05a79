"""Mamba2-2.7B [arXiv:2405.21060] — attention-free SSM (SSD).

64L, d_model 2560, d_ff 0 (no FFN; the Mamba block IS the mixer),
vocab 50280, ssm_state 128, headdim 64, expand 2.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv=4,
    tie_embeddings=True,
    sub_quadratic=True,
    source="arXiv:2405.21060",
)
