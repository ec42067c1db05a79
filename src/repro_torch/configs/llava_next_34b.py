"""LLaVA-NeXT 34B [hf:llava-hf/llava-v1.6-*] — VLM backbone.

60L, d_model 7168, 56 heads / 8 KV, d_ff 20480, vocab 64000.  The
anyres-tiling vision tower is a STUB: input_specs() provides
precomputed patch embeddings (B, n_patches, d_model) interleaved with
text tokens.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    head_dim=128,
    n_patches=2880,          # anyres: up to 5 tiles x 576 patches
    frontend="vision",
    sub_quadratic=False,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf (scaled per 34B card)",
)
