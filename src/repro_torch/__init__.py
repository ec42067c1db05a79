"""PyTorch / CUDA port of the PBQP primitive-selection system.

Mirrors the JAX package ``repro`` module by module (same subpackage
paths, same public names) and imports nothing of it.  The five kernel
primitives run hand-written CUDA kernels for Hopper (``csrc/``) on CUDA
tensors and their plain PyTorch versions on CPU tensors.

Entry points (``core.plan.compile_plan``, ``core.costs.ProfiledCostModel``)
run on the card unless the caller passes ``device="cpu"``; with no GPU
present they raise rather than carry on on the CPU.  They run the
library primitives in true f32 (TF32 off, ``kernels.common.true_f32``)
as the reference assumes, scoped to their own calls.
"""
from __future__ import annotations

__all__ = ["core", "convnets", "kernels", "obs"]
