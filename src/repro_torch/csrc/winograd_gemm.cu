// Batched GEMM over the Winograd transform points:
//   Q[n, p] = U[p] @ V[n, p]    U (P, M, C), V (N, P, C, T), Q (N, P, M, T)
// with P = alpha^2 (16 for F(2,3), 36 for F(4,3)), T the tiles of one
// image and N the images of a batch; f32 in, f32 accumulation.
//
// Replaces: src/repro/kernels/winograd_gemm/kernel.py
// winograd_bgemm_pallas (body _bgemm_kernel).
//
// Bound on the H100: at AlexNet's conv3..conv5 (M 256..384, C 256..384,
// T = 49 tiles per image at F(2,3), 16 at F(4,3)) each point's product
// does 2*M*C*T operations on 4*(M*C + C*T + M*T) bytes, 7 to 19
// operations per byte at batch 1, below the f32 CUDA-core ridge of
// 67e12 / 3.35e12 = 20: bound by the bytes of the packed weights U.
// A batch of images reuses U and moves the kernel toward operations.
//
// Design: the same 64 x 64 tiled core as the GEMM (tile_gemm.cuh), the
// contraction over C looping inside the block.  blockIdx.z walks
// (image, point) pairs; U's image stride is 0, so every image shares
// the packed weights.  C and T are masked at the ragged edges instead of
// padded to block multiples as the reference does.
#include "tile_gemm.cuh"

extern "C" {

int repro_wino_bgemm(const void* u, const void* v, void* q, int P, int M,
                     int C, int T, int nimg, void* stream) {
  const int64_t mc = int64_t(M) * C, ct = int64_t(C) * T,
                mt = int64_t(M) * T;
  return repro::launch_strided_gemm<float>(
      static_cast<const float*>(u), static_cast<const float*>(v), nullptr,
      static_cast<float*>(q), M, T, C, /*sam=*/C, /*sak=*/1, /*sbk=*/T,
      /*sbn=*/1, /*scm=*/T, /*scn=*/1, /*nb1=*/nimg, /*nb2=*/P,
      /*sa1=*/0, /*sa2=*/mc, /*sb1=*/P * ct, /*sb2=*/ct, /*sc1=*/P * mt,
      /*sc2=*/mt, /*relu=*/0, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
