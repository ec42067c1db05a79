// Tiled GEMM with an optional fused bias + ReLU epilogue, f32, bf16 or
// f16 inputs (one dtype for all operands), f32 accumulation, the output
// in the input's dtype.  Serves repro_torch.kernels.matmul and,
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
// = 20: it is bound by operations.  GoogLeNet's 1x1 GEMMs (K 64..192)
// sit near the ridge.
//
// Design: the mainloop of sgemm_sm90.cuh -- 128 x 128, 64 x 64, 128 x 32
// or 128 x 16 tiles of register-blocked accumulators, a 4-stage cp.async
// ring, and split-K across a cluster of up to 8 blocks reduced through
// distributed shared memory, so that batch-1 GEMMs with few output tiles
// and long K (AlexNet's conv3..conv5: 12 to 18 tiles of 64 x 64, K 2304
// and 3456) still fill the 132 SMs.  The launch planner
// (kernels/matmul/plan.py) picks the tile, the number of splits, the K
// slice and the copy widths.  The TPU kernel's layout options become
// strides: a transposed ("km") LHS and a transposed ("nm") output are
// just other strides, read and written where they lie; the staged
// epilogue stores along whichever output axis is contiguous.  Ragged
// edges are zero-filled by the copies instead of padded.  Images of a
// batch (and any other batch axis) ride on blockIdx.z.
#include "sgemm_sm90.cuh"

namespace {

template <typename T>
int matmul(const void* a, const void* b, const void* bias, void* c, int M,
           int N, int K, int64_t sam, int64_t sak, int64_t sbk, int64_t sbn,
           int64_t scm, int64_t scn, int nb, int64_t sab, int64_t sbb,
           int64_t scb, int relu, int tile, int splits, int kslice,
           int vec_a, int vec_b, void* stream) {
  const repro::sm90::GemmArgs<T> p{
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(bias), static_cast<T*>(c), M, N, K, sam, sak,
      sbk, sbn, scm, scn, sab, sbb, scb, relu, splits, kslice, vec_a, vec_b};
  return repro::sm90::gemm(p, nb, tile, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// tile, splits, kslice, vec_a, vec_b: the launch planner's choice
// (kernels/matmul/plan.py), refused with cudaErrorInvalidValue where the
// kernel cannot run it.
int repro_matmul_f32(const void* a, const void* b, const void* bias,
                     void* c, int M, int N, int K, int64_t sam, int64_t sak,
                     int64_t sbk, int64_t sbn, int64_t scm, int64_t scn,
                     int nb, int64_t sab, int64_t sbb, int64_t scb, int relu,
                     int tile, int splits, int kslice, int vec_a, int vec_b,
                     void* stream) {
  return matmul<float>(a, b, bias, c, M, N, K, sam, sak, sbk, sbn, scm, scn,
                       nb, sab, sbb, scb, relu, tile, splits, kslice, vec_a,
                       vec_b, stream);
}

int repro_matmul_bf16(const void* a, const void* b, const void* bias,
                      void* c, int M, int N, int K, int64_t sam, int64_t sak,
                      int64_t sbk, int64_t sbn, int64_t scm, int64_t scn,
                      int nb, int64_t sab, int64_t sbb, int64_t scb,
                      int relu, int tile, int splits, int kslice, int vec_a,
                      int vec_b, void* stream) {
  return matmul<__nv_bfloat16>(a, b, bias, c, M, N, K, sam, sak, sbk, sbn,
                               scm, scn, nb, sab, sbb, scb, relu, tile,
                               splits, kslice, vec_a, vec_b, stream);
}

int repro_matmul_f16(const void* a, const void* b, const void* bias,
                     void* c, int M, int N, int K, int64_t sam, int64_t sak,
                     int64_t sbk, int64_t sbn, int64_t scm, int64_t scn,
                     int nb, int64_t sab, int64_t sbb, int64_t scb, int relu,
                     int tile, int splits, int kslice, int vec_a, int vec_b,
                     void* stream) {
  return matmul<__half>(a, b, bias, c, M, N, K, sam, sak, sbk, sbn, scm,
                        scn, nb, sab, sbb, scb, relu, tile, splits, kslice,
                        vec_a, vec_b, stream);
}

}  // extern "C"
