// Tiled GEMM with an optional fused bias + ReLU epilogue, f32 or bf16
// inputs, f32 accumulation.  Serves repro_torch.kernels.matmul and,
// through it, the im2col convolution (repro_torch.kernels.conv_im2col).
//
// Replaces: src/repro/kernels/matmul/kernel.py matmul_pallas (bodies
// _mm_kernel and _mm_bias_kernel), and its alias
// src/repro/kernels/conv_im2col/kernel.py im2col_gemm_pallas.
//
// Bound on the H100: at the main path's shapes (the im2col GEMMs of
// AlexNet, M 96..384, K 363..3456, N 169..3025 per image) the product
// does 2*M*N*K operations on 4*(M*K + K*N + M*N) bytes, 37 to 88
// operations per byte, above the f32 CUDA-core ridge of 67e12 / 3.35e12
// = 20: it is bound by operations.
//
// Design: 64 x 64 output tiles, 256 threads with 4 x 4 f32 accumulators
// each, the K loop inside the block over 16-wide shared-memory slices
// (tile_gemm.cuh).  The TPU kernel's layout options become strides: a
// transposed ("km") LHS and a transposed ("nm") output are just other
// strides, read and written where they lie, so no transpose pass is
// made.  Ragged edges are masked in the kernel instead of padded.
// Images of a batch (and any other batch axis) ride on blockIdx.z.
#include "tile_gemm.cuh"

extern "C" {

int repro_matmul_f32(const void* a, const void* b, const void* bias,
                     void* c, int M, int N, int K, int64_t sam, int64_t sak,
                     int64_t sbk, int64_t sbn, int64_t scm, int64_t scn,
                     int nb, int64_t sab, int64_t sbb, int64_t scb, int relu,
                     void* stream) {
  return repro::launch_strided_gemm<float>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(bias), static_cast<float*>(c), M, N, K, sam,
      sak, sbk, sbn, scm, scn, nb, 1, sab, 0, sbb, 0, scb, 0, relu,
      static_cast<cudaStream_t>(stream));
}

int repro_matmul_bf16(const void* a, const void* b, const void* bias,
                      void* c, int M, int N, int K, int64_t sam, int64_t sak,
                      int64_t sbk, int64_t sbn, int64_t scm, int64_t scn,
                      int nb, int64_t sab, int64_t sbb, int64_t scb,
                      int relu, void* stream) {
  return repro::launch_strided_gemm<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(c), M, N, K, sam, sak, sbk, sbn, scm, scn,
      nb, 1, sab, 0, sbb, 0, scb, 0, relu, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
