from .bench import benchmark_entry
from .kernel import im2col_gemm_cuda
from .ops import conv_im2col, im2col_gemm
from .ref import conv_im2col_ref

__all__ = ["benchmark_entry", "conv_im2col", "conv_im2col_ref", "im2col_gemm",
           "im2col_gemm_cuda"]
