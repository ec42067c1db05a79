from .bench import benchmark_entry
from .kernel import HEAD_DIMS, LIB, flash_attention_cuda
from .ops import flash_attention
from .ref import flash_attention_ref

__all__ = ["HEAD_DIMS", "LIB", "benchmark_entry", "flash_attention",
           "flash_attention_cuda", "flash_attention_ref"]
