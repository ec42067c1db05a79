from .bench import benchmark_entry
from .kernel import LIB, attention_plan, flash_attention_cuda
from .ops import flash_attention
from .plan import AttnPlan, plan_attention
from .ref import flash_attention_ref

__all__ = ["AttnPlan", "LIB", "attention_plan", "benchmark_entry",
           "flash_attention", "flash_attention_cuda", "flash_attention_ref",
           "plan_attention"]
