from .kernel import LIB, matmul_cuda
from .ops import matmul
from .ref import matmul_ref

__all__ = ["LIB", "matmul", "matmul_cuda", "matmul_ref"]
