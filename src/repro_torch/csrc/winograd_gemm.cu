// Batched GEMM over the Winograd transform points, f32, bf16 or f16 in
// (one dtype for U, V and Q), f32 accumulation, Q in the input's dtype:
//   Q[p] = U[p] @ V[p]    U (P, M, C), V (P, C, N), Q (P, M, N)
// with P = alpha^2 (16 for F(2,3), 36 for F(4,3)) and N the tiles of
// every image of the batch side by side (N = images * T).
//
// Replaces: src/repro/kernels/winograd_gemm/kernel.py
// winograd_bgemm_pallas (body _bgemm_kernel).
//
// Bound on the H100: at AlexNet's conv3..conv5 (M 256..384, C 256..384)
// one image has T = 49 tiles at F(2,3) and 16 at F(4,3).  At batch 1 each
// point's product does 2*M*C*T operations on 4*(M*C + C*T + M*T) bytes,
// 7 to 20 operations per byte, at or below the f32 CUDA-core ridge of
// 67e12 / 3.35e12 = 20: bound by the bytes of the packed weights U
// (6.3 to 21 MB a layer).  At batch 8, N = 392 or 128 and U is read once
// for all eight images: 35 to 64 operations per byte, bound by
// operations.
//
// Design: the pipelined mainloop of sgemm_sm90.cuh, with the points on
// blockIdx.z and the launch planner's tile, cluster split-K and copy
// widths (kernels/matmul/plan.py).  The images of a batch are folded
// into N by the input transform, which writes V as (P, C, images * T):
// every output tile sees whole columns of the batch, and U is read once
// per point, not once per image.  At batch 1 the narrow 128 x 32 tile
// keeps F(4,3)'s 16 columns from idling 3/4 of a 64-wide tile, and split-K
// fills the card where M / BM * P blocks would not.  U is packed with M
// contiguous ((P, C, M) in memory), so its copies are 16 bytes; V's are 16
// bytes where N is a multiple of 4.  The split-K sum runs in rank order:
// the same bits on every call.  bf16 and f16 run the same mainloop,
// converting to f32 as they are loaded (through registers, 2 bytes an
// element).
#include "sgemm_sm90.cuh"

namespace {

template <typename T>
int wino_bgemm(const void* u, const void* v, void* q, int P, int M, int N,
               int C, int64_t sam, int64_t sak, int64_t sab, int64_t sbk,
               int64_t sbn, int64_t sbb, int tile, int splits, int kslice,
               int vec_a, int vec_b, void* stream) {
  const repro::sm90::GemmArgs<T> p{
      static_cast<const T*>(u), static_cast<const T*>(v), nullptr,
      static_cast<T*>(q), M, N, C, sam, sak, sbk, sbn,
      /*scm=*/N, /*scn=*/1, sab, sbb, /*scb=*/int64_t(M) * N, /*relu=*/0,
      splits, kslice, vec_a, vec_b};
  return repro::sm90::gemm(p, P, tile, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// sam, sak, sab: U's strides (m, c, p); sbk, sbn, sbb: V's (c, n, p); Q is
// contiguous (P, M, N).  tile, splits, kslice, vec_a, vec_b: the launch
// planner's choice (kernels/matmul/plan.py), refused with
// cudaErrorInvalidValue where the kernel cannot run it.
int repro_wino_bgemm(const void* u, const void* v, void* q, int P, int M,
                     int N, int C, int64_t sam, int64_t sak, int64_t sab,
                     int64_t sbk, int64_t sbn, int64_t sbb, int tile,
                     int splits, int kslice, int vec_a, int vec_b,
                     void* stream) {
  return wino_bgemm<float>(u, v, q, P, M, N, C, sam, sak, sab, sbk, sbn, sbb,
                           tile, splits, kslice, vec_a, vec_b, stream);
}

// The same for bf16 and f16 operands (vec_a = vec_b = 1).
int repro_wino_bgemm_bf16(const void* u, const void* v, void* q, int P,
                          int M, int N, int C, int64_t sam, int64_t sak,
                          int64_t sab, int64_t sbk, int64_t sbn, int64_t sbb,
                          int tile, int splits, int kslice, int vec_a,
                          int vec_b, void* stream) {
  return wino_bgemm<__nv_bfloat16>(u, v, q, P, M, N, C, sam, sak, sab, sbk,
                                   sbn, sbb, tile, splits, kslice, vec_a,
                                   vec_b, stream);
}

int repro_wino_bgemm_f16(const void* u, const void* v, void* q, int P, int M,
                         int N, int C, int64_t sam, int64_t sak, int64_t sab,
                         int64_t sbk, int64_t sbn, int64_t sbb, int tile,
                         int splits, int kslice, int vec_a, int vec_b,
                         void* stream) {
  return wino_bgemm<__half>(u, v, q, P, M, N, C, sam, sak, sab, sbk, sbn, sbb,
                            tile, splits, kslice, vec_a, vec_b, stream);
}

}  // extern "C"
