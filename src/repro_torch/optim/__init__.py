"""Optimizers and gradient compression of the port (``optim/``), over
nested dicts of tensors; ``compressed_psum_tree`` is the quantised
all-reduce over a process group."""
from .compression import compressed_psum_tree, dequantize_int8, quantize_int8
from .optimizers import (
    Optimizer, adafactor, adamw, clip_by_global_norm, for_config,
    global_norm, warmup_cosine,
)

__all__ = [
    "Optimizer", "adamw", "adafactor", "clip_by_global_norm", "for_config",
    "global_norm", "warmup_cosine", "quantize_int8", "dequantize_int8",
    "compressed_psum_tree",
]
