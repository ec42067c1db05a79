from .kernel import LIB, conv_direct_cuda
from .ops import conv_direct
from .ref import conv_direct_ref

__all__ = ["LIB", "conv_direct", "conv_direct_cuda", "conv_direct_ref"]
