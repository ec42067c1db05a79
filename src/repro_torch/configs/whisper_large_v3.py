"""Whisper-large-v3 [arXiv:2212.04356] — encoder-decoder, audio.

32+32L, d_model 1280, 20 heads (MHA: kv=20), d_ff 5120, vocab 51866.
The conv frontend is a STUB: input_specs() provides precomputed frame
embeddings of shape (B, enc_seq, d_model).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,            # decoder layers
    enc_layers=32,
    enc_seq=1500,           # 30 s of audio at 50 Hz after the conv stub
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    head_dim=64,
    frontend="audio",
    sub_quadratic=False,
    source="arXiv:2212.04356",
)
