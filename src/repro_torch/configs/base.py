"""Config dataclasses for the LM-family architectures and run shapes."""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1          # MoE replaces dense FFN every n-th layer
    capacity_factor: float = 1.25

    # --- attention features ---
    sliding_window: int = 0     # gemma2 local layers
    local_global_period: int = 0  # alternate local/global every n layers
    logit_softcap: float = 0.0  # final-logit softcap (gemma2)
    attn_softcap: float = 0.0   # attention-logit softcap (gemma2)
    rope_theta: float = 1e4
    qk_norm: bool = False

    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    attn_every: int = 0         # hybrid: 1 attention layer per n blocks

    # --- encoder-decoder (whisper) ---
    enc_layers: int = 0
    enc_seq: int = 0            # encoder sequence length (frontend stub)

    # --- modality frontend stubs ---
    frontend: str = "none"      # none | audio | vision
    n_patches: int = 0          # vision stub: patch embeddings per image

    # --- block structure ---
    post_norms: bool = False      # gemma2 sandwich norms
    parallel_block: bool = False  # command-r parallel attn+FFN

    # --- misc ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    #: True if the arch supports the long_500k shape (sub-quadratic path)
    sub_quadratic: bool = False
    #: reference/source for the config (provenance)
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def scaled_down(self, **kw) -> "ModelConfig":
        """Reduced config of the same family for CPU smoke tests."""
        defaults = dict(
            n_layers=min(self.n_layers, 2 * max(1, self.local_global_period,
                                                self.attn_every,
                                                self.moe_every)),
            d_model=128,
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads or 1, 2),
            d_ff=256,
            vocab=512,
            head_dim=32 if self.head_dim else 0,
            enc_layers=min(self.enc_layers, 2),
            enc_seq=min(self.enc_seq, 64) if self.enc_seq else 0,
            n_patches=min(self.n_patches, 16) if self.n_patches else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            # drop-free capacity so decode == forward exactly in tests
            capacity_factor=float(max(4, min(self.n_experts, 4)))
                if self.n_experts else 1.25,
            sliding_window=min(self.sliding_window, 16)
                if self.sliding_window else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else 64,
            name=self.name + "-smoke",
        )
        defaults.update(kw)
        return replace(self, **defaults)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
