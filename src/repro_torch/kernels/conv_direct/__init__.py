from .bench import benchmark_entry
from .kernel import LIB, conv_direct_cuda, conv_plan
from .ops import conv_direct
from .ref import conv_direct_ref

__all__ = ["LIB", "benchmark_entry", "conv_direct", "conv_direct_cuda",
           "conv_direct_ref", "conv_plan"]
