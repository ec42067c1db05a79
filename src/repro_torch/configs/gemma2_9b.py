"""Gemma2-9B [arXiv:2408.00118].

42L, d_model 3584, 16 heads / 8 KV, head_dim 256, d_ff 14336,
vocab 256000.  Alternating local (sliding-window 4096) / global
attention, attention + final-logit soft-capping.

long_500k: runs — half the layers are sliding-window (bounded KV), and
decode-time global attention is linear per token; we mark it
sub-quadratic for the decode-only long-context shape (see
docs/distributed.md §CPU-world testing of pod-world claims for why
full-attention architectures skip that shape).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    d_ff=14336,
    vocab=256000,
    head_dim=256,
    sliding_window=4096,
    local_global_period=2,   # local, global, local, ...
    attn_softcap=50.0,
    logit_softcap=30.0,
    post_norms=True,
    tie_embeddings=True,
    sub_quadratic=True,
    source="arXiv:2408.00118",
)
