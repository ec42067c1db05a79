from .bench import benchmark_entry
from .kernel import LIB, winograd_bgemm_cuda
from .ops import conv_winograd, prepare_kernel, winograd_bgemm
from .ref import bgemm_ref

__all__ = ["LIB", "benchmark_entry", "bgemm_ref", "conv_winograd",
           "prepare_kernel", "winograd_bgemm", "winograd_bgemm_cuda"]
