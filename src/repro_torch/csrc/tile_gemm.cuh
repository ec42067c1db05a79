// Block-tiled GEMM core shared by the port's Hopper kernels:
// matmul.cu (GEMM), winograd_gemm.cu (Winograd batched GEMM) and
// conv_direct.cu (direct convolution as an implicit GEMM).
//
// One block of 256 threads computes a 64 x 64 tile of C = A @ B with an
// f32 accumulator in registers (4 x 4 per thread).  The contraction
// loops inside the block in steps of 16: the TPU kernels' sequential K
// grid axis becomes this loop, because Hopper runs blocks in parallel
// and in no order.  Each step stages a 64 x 16 slice of A and a 16 x 64
// slice of B in shared memory (8.7 KB in all), so the ragged edges are
// masked here and no operand is ever padded in device memory.
//
// Operands are read through loader functors, so strides, transposed
// layouts and gathered (implicit-GEMM) operands all use one loop.
// Plain f32 FMA on the CUDA cores; no wgmma and no TMA yet.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int RY = BM / TM;  // 16 thread rows
constexpr int RX = BN / TN;  // 16 thread columns

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void store_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

// Accumulates the (m0, n0) tile of an M x N x K product and hands each
// in-range result to sc(m, n, value).
//   la(m, k), lb(k, n): one in-range operand element as float;
//   a_k_fast / b_n_fast: which index of A / B walks contiguous memory,
//   so that neighbouring threads load neighbouring addresses.
template <class LA, class LB, class SC>
__device__ __forceinline__ void tile_gemm(int M, int N, int K, int m0,
                                          int n0, const LA& la,
                                          const LB& lb, const SC& sc,
                                          bool a_k_fast, bool b_n_fast) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % RX;
  const int ty = tid / RX;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      int mm, kk;
      if (a_k_fast) {
        mm = e / BK;
        kk = e % BK;
      } else {
        kk = e / BM;
        mm = e % BM;
      }
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K) ? la(gm, gk) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (BN * BK) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      int nn, kk;
      if (b_n_fast) {
        kk = e / BN;
        nn = e % BN;
      } else {
        nn = e / BK;
        kk = e % BK;
      }
      const int gn = n0 + nn, gk = k0 + kk;
      Bs[kk][nn] = (gn < N && gk < K) ? lb(gk, gn) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * RY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + j * RX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gm = m0 + ty + i * RY, gn = n0 + tx + j * RX;
      if (gm < M && gn < N) sc(gm, gn, acc[i][j]);
    }
}

// C[z] = A[z] @ B[z] (+ bias over N) (ReLU) for a two-level batch
// z = z1 * nb2 + z2 on blockIdx.z, every operand addressed by strides.
template <typename T>
__global__ void __launch_bounds__(THREADS)
strided_gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    const T* __restrict__ bias, T* __restrict__ c, int M,
                    int N, int K, int64_t sam, int64_t sak, int64_t sbk,
                    int64_t sbn, int64_t scm, int64_t scn, int nb2,
                    int64_t sa1, int64_t sa2, int64_t sb1, int64_t sb2,
                    int64_t sc1, int64_t sc2, int relu) {
  const int z1 = blockIdx.z / nb2, z2 = blockIdx.z % nb2;
  a += z1 * sa1 + z2 * sa2;
  b += z1 * sb1 + z2 * sb2;
  c += z1 * sc1 + z2 * sc2;
  auto la = [=](int m, int k) { return to_f32(a[m * sam + k * sak]); };
  auto lb = [=](int k, int n) { return to_f32(b[k * sbk + n * sbn]); };
  auto sc = [=](int m, int n, float v) {
    if (bias != nullptr) v += to_f32(bias[n]);
    if (relu) v = fmaxf(v, 0.f);
    store_f32(v, &c[m * scm + n * scn]);
  };
  tile_gemm(M, N, K, blockIdx.y * BM, blockIdx.x * BN, la, lb, sc,
            sak == 1, sbn == 1);
}

template <typename T>
int launch_strided_gemm(const T* a, const T* b, const T* bias, T* c, int M,
                        int N, int K, int64_t sam, int64_t sak, int64_t sbk,
                        int64_t sbn, int64_t scm, int64_t scn, int nb1,
                        int nb2, int64_t sa1, int64_t sa2, int64_t sb1,
                        int64_t sb2, int64_t sc1, int64_t sc2, int relu,
                        cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, nb1 * nb2);
  strided_gemm_kernel<T><<<grid, THREADS, 0, stream>>>(
      a, b, bias, c, M, N, K, sam, sak, sbk, sbn, scm, scn, nb2, sa1, sa2,
      sb1, sb2, sc1, sc2, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro
