from .bench import benchmark_entry
from .kernel import LIB, matmul_cuda, matmul_plan
from .ops import matmul
from .plan import GemmPlan, plan_gemm
from .ref import matmul_ref

__all__ = ["LIB", "GemmPlan", "benchmark_entry", "matmul", "matmul_cuda",
           "matmul_plan", "matmul_ref", "plan_gemm"]
