"""im2col convolution's kernel: the GEMM kernel (K1, ``csrc/matmul.cu``)
over the patch matrix, as the reference's ``im2col_gemm_pallas`` is its
fused-bias matmul kernel.  Re-exported here, at the reference's path;
the patches are built by ``ops.py`` (``F.unfold``)."""
from __future__ import annotations

from ..matmul.kernel import matmul_cuda

# the kernel itself is the GEMM; re-exported for clarity
im2col_gemm_cuda = matmul_cuda

__all__ = ["im2col_gemm_cuda"]
