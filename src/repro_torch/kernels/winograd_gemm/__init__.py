from .kernel import LIB, winograd_bgemm_cuda
from .ops import conv_winograd, prepare_kernel, winograd_bgemm
from .ref import bgemm_ref

__all__ = ["LIB", "bgemm_ref", "conv_winograd", "prepare_kernel",
           "winograd_bgemm", "winograd_bgemm_cuda"]
