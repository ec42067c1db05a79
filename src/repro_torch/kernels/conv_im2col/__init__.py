from .ops import conv_im2col, im2col_gemm
from .ref import conv_im2col_ref

__all__ = ["conv_im2col", "conv_im2col_ref", "im2col_gemm"]
