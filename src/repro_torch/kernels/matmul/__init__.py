from .bench import benchmark_entry
from .kernel import LIB, matmul_cuda
from .ops import matmul
from .ref import matmul_ref

__all__ = ["LIB", "benchmark_entry", "matmul", "matmul_cuda", "matmul_ref"]
