// Pipelined, register-blocked f32 GEMM mainloop for Hopper (sm_90a), with
// split-K across a thread-block cluster.  Serves matmul.cu (the GEMM
// behind K1 and K2), winograd_gemm.cu (K3, the batched GEMM over the
// Winograd transform points) and conv_direct.cu (K4, an implicit GEMM).
//
// C = A @ B accumulates in true f32 on the CUDA cores (no TF32, no wgmma),
// so the bound is max(flops / 67e12, bytes / 3.35e12).  The design:
//
// * Register blocking.  Each thread holds TM x TN accumulators of a
//   BM x BN tile: 128 x 128 with 8 x 8 on 256 threads and K steps of 16,
//   64 x 64 with 4 x 4 on 256 threads and K steps of 32 (fewer barriers
//   for its shorter FMA runs), 128 x 32 with 8 x 4 on 128 threads and K
//   steps of 16, or 128 x 16 with 4 x 4 on 128 threads and K steps of 32
//   (the last two for a short N).  Both operands are staged K-major in
//   shared memory, s[k][row] with a pitch of rows + 4 floats, so each
//   thread reads its A and B fragments as float4s; a warp of 4 x 8
//   (8 x 4) threads reads 4 (8) distinct A float4s and 8 (4) distinct B
//   float4s, free of bank conflicts.  An operand whose K axis is the
//   contiguous one is transposed on its way in.
// * A ring of STAGES slices filled by cp.async, STAGES - 1 ahead of the
//   FMAs, so global latency hides behind the previous slices' math.
//   Ragged edges and padding are zero-filled by the copy (src-size 0).
//   Copies are 16 bytes only where the planner found the staged axis
//   contiguous and 16-byte aligned (vec == 4); elsewhere they are 4
//   bytes, which is the common case at AlexNet's odd N and K.  The bf16
//   and f16 entries load through registers and convert there: the same
//   f32 mainloop, the output rounded once to the input's dtype.
// * Split-K in one launch with no workspace.  The S blocks of a cluster
//   (S <= 8, on grid x) share one output tile, each reducing a contiguous
//   slice of K.  Each block parks its partial tile in its own (now idle)
//   ring, and after cluster.sync() rank q sums the q-th 1/S of the tile
//   over every rank's shared memory (distributed shared memory), 16 bytes
//   at a time, in rank order: the result is the same bits on every call.
//   Bias and ReLU are applied once, after the sum, by the store functor.
//   The staged tile also lets the final stores walk whichever output axis
//   is contiguous.
//
// Operands are read through loader objects: cursor(row, k) resolves an
// element's row once, at(cursor, k) returns the address of (row, k) (or,
// where PADS, nullptr for a zero: padding), and advance(cursor, bk)
// steps it one slice along K.  So strided, transposed and gathered
// (implicit-GEMM) operands share one loop, and the per-slice work of a
// copy is an add and a bounds test.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace repro {
namespace sm90 {

namespace cg = cooperative_groups;

constexpr int STAGES = 4;
constexpr int MAX_SPLITS = 8;  // the portable cluster size

template <int BM_, int BN_, int BK_, int TM_, int TN_, int MIN_BLOCKS_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int RY = BM / TM, RX = BN / TN;  // threads along M, N
  static constexpr int THREADS = RY * RX;           // one block of acc each
  // a warp covers WY x WX threads: 4 x 8, or 8 x 4 where RX is 4
  static constexpr int WX = RX < 8 ? RX : 8, WY = 32 / WX;
  static_assert(WX * WY == 32 && RY % WY == 0 && RX % WX == 0,
                "whole warps of 4 x 8 or 8 x 4 threads");
  static_assert(TM % 4 == 0 && TN % 4 == 0, "float4 fragments");
  static constexpr int PA = BM + 4, PB = BN + 4;  // staged pitches
  static constexpr int STAGE = BK * (PA + PB);    // floats per stage
  static constexpr int RING = STAGES * STAGE;     // floats in the ring
  static_assert(BM * (BN + 4) <= RING && BN * (BM + 4) <= RING,
                "the staged output tile fits the ring");
};
// The C entries' `tile` argument: 0 to 3 (kernels/matmul/plan.py
// TILES).  The narrow ones, 128 x 32 and 128 x 16 on 128 threads, serve
// products with a short N (the Winograd GEMM's 16 tiles of an image at
// F(4,3)), which a 64-wide tile would leave 3/4 idle; several of their
// blocks share an SM.
using Tile128 = Tile<128, 128, 16, 8, 8, 1>;
using Tile64 = Tile<64, 64, 32, 4, 4, 2>;
using Tile128x32 = Tile<128, 32, 16, 8, 4, 3>;
using Tile128x16 = Tile<128, 16, 32, 4, 4, 2>;
constexpr int NUM_TILES = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ void store_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void store_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store_f32(float v, __half* p) {
  *p = __float2half(v);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// bytes < size zero-fills the rest of the destination; 0 reads nothing
__device__ __forceinline__ void cp_async4(float* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One element into shared memory as f32, or 0 where !ok (then src is
// any valid global address, and the copy reads nothing).
template <typename T>
__device__ __forceinline__ void copy1(float* dst, const T* src, bool ok) {
  if constexpr (std::is_same<T, float>::value) {
    cp_async4(dst, src, ok ? 4 : 0);
  } else {
    *dst = ok ? to_f32(*src) : 0.f;
  }
}

// Element (row, k) at base[row * srow + k * sk].  Operands hand out a
// cursor per (row, first k) of the thread's slice, which then steps along
// K by a slice's depth: here a pointer, advanced by an add.
template <typename T>
struct Strided {
  static constexpr bool PADS = false;  // at() never returns nullptr
  const T* base;
  int64_t srow, sk;
  struct Cursor {
    const T* p;
  };
  __device__ __forceinline__ Cursor cursor(int row, int k) const {
    return {base + row * srow + k * sk};
  }
  __device__ __forceinline__ const T* at(const Cursor& c, int) const {
    return c.p;
  }
  __device__ __forceinline__ void advance(Cursor& c, int bk) const {
    c.p += bk * sk;
  }
};

// The elements of one operand's ROWS x BK slice that this thread copies,
// slice after slice, staged as s[k][row] (pitch ROWS + 4): element i sits
// at row mm0 + i * mstep, k kk0 + i * kstep of the slice.  vec == 4: the
// row axis is contiguous and aligned, 16-byte copies of 4 rows.  Else
// k_fast says which axis neighbouring threads walk, so that they read
// neighbouring addresses.  Each element's row (its cursor and how many of
// its rows lie inside the operand) is resolved once, at construction.
template <int ROWS, int BK, int THREADS, typename T, class Op>
struct SliceCopier {
  static constexpr int P = ROWS + 4;
  static constexpr int N = ROWS * BK / THREADS;       // 4-byte copies
  static constexpr int NV = ROWS / 4 * BK / THREADS;  // 16-byte copies
  static_assert(N * THREADS == ROWS * BK && NV * THREADS == ROWS / 4 * BK,
                "every thread copies as many elements of a slice");
  typename Op::Cursor cur[N];
  int rows[N];  // rows of the element inside the operand: 0..1 or 0..4
  int kk0, kstep, dst0, dstep;
  bool vec;

  __device__ __forceinline__ SliceCopier(const Op& op, int row0, int k0,
                                         int rows_lim, int vec4,
                                         bool k_fast) {
    const int tid = threadIdx.x;
    vec = std::is_same<T, float>::value && vec4 == 4;
    int mm0, mstep;
    if (vec) {
      constexpr int G = ROWS / 4;
      kk0 = tid / G, kstep = THREADS / G, mm0 = tid % G * 4, mstep = 0;
    } else if (k_fast) {
      kk0 = tid % BK, kstep = 0, mm0 = tid / BK, mstep = THREADS / BK;
    } else {
      kk0 = tid / ROWS, kstep = THREADS / ROWS, mm0 = tid % ROWS, mstep = 0;
    }
    dst0 = kk0 * P + mm0;
    dstep = kstep * P + mstep;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int gr = row0 + mm0 + i * mstep;
      rows[i] = min(max(rows_lim - gr, 0), vec ? 4 : 1);
      cur[i] = op.cursor(rows[i] ? gr : row0, k0 + kk0 + i * kstep);
    }
  }

  // Copies the slice at k origin k0 (the next one in order); elements at
  // or past k_end are zero.
  __device__ __forceinline__ void copy(float* s, const Op& op, int k0,
                                       int k_end) {
    if constexpr (std::is_same<T, float>::value) {
      if (vec) {
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int gk = k0 + kk0 + i * kstep;
          const int n = gk < k_end ? rows[i] : 0;
          cp_async16(s + dst0 + i * dstep, n ? op.at(cur[i], gk) : op.base,
                     4 * n);
          op.advance(cur[i], BK);
        }
        return;
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int gk = k0 + kk0 + i * kstep;
      bool ok = rows[i] && gk < k_end;
      const T* src;
      if constexpr (Op::PADS) {
        src = ok ? op.at(cur[i], gk) : nullptr;
        ok = src != nullptr;
      } else {
        src = op.at(cur[i], gk);
      }
      copy1(s + dst0 + i * dstep, ok ? src : op.base, ok);
      op.advance(cur[i], BK);
    }
  }
};

// Thread (ty, tx) owns rows (i / 4) * RY * 4 + ty * 4 + i % 4 and
// columns (j / 4) * RX * 4 + tx * 4 + j % 4 of the tile.  A warp covers
// WY x WX (4 x 8 or 8 x 4) of the RY x RX threads, so that each of its
// fragment reads touches at most 8 distinct float4s: one 128-byte
// wavefront.
template <class Cfg>
__device__ __forceinline__ int thread_y() {
  return threadIdx.x / 32 / (Cfg::RX / Cfg::WX) * Cfg::WY +
         threadIdx.x % 32 / Cfg::WX;
}
template <class Cfg>
__device__ __forceinline__ int thread_x() {
  return threadIdx.x / 32 % (Cfg::RX / Cfg::WX) * Cfg::WX +
         threadIdx.x % Cfg::WX;
}
template <class Cfg>
__device__ __forceinline__ int acc_row(int i, int ty) {
  return (i / 4) * Cfg::RY * 4 + ty * 4 + i % 4;
}
template <class Cfg>
__device__ __forceinline__ int acc_col(int j, int tx) {
  return (j / 4) * Cfg::RX * 4 + tx * 4 + j % 4;
}

template <class Cfg>
__device__ __forceinline__ void fma_slice(const float* As, const float* Bs,
                                          float (&acc)[Cfg::TM][Cfg::TN],
                                          int ty, int tx) {
#pragma unroll
  for (int kk = 0; kk < Cfg::BK; ++kk) {
    float a[Cfg::TM], b[Cfg::TN];
#pragma unroll
    for (int g = 0; g < Cfg::TM / 4; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(
          As + kk * Cfg::PA + g * Cfg::RY * 4 + ty * 4);
      a[4 * g] = v.x, a[4 * g + 1] = v.y, a[4 * g + 2] = v.z,
      a[4 * g + 3] = v.w;
    }
#pragma unroll
    for (int g = 0; g < Cfg::TN / 4; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(
          Bs + kk * Cfg::PB + g * Cfg::RX * 4 + tx * 4);
      b[4 * g] = v.x, b[4 * g + 1] = v.y, b[4 * g + 2] = v.z,
      b[4 * g + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < Cfg::TM; ++i)
#pragma unroll
      for (int j = 0; j < Cfg::TN; ++j)
        acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Adds A[m0:, kb:ke] @ B[kb:ke, n0:] to acc.  A and B are loaders in
// (row, k) form (B's rows are the columns of C).  Leaves the ring idle:
// every copy landed and every thread past its last read.
template <class Cfg, typename T, class OA, class OB>
__device__ __forceinline__ void mainloop(float* smem, const OA& oa,
                                         const OB& ob, int m0, int n0, int M,
                                         int N, int kb, int ke, int vec_a,
                                         int vec_b, bool a_k_fast,
                                         bool b_k_fast,
                                         float (&acc)[Cfg::TM][Cfg::TN]) {
  const int ty = thread_y<Cfg>(), tx = thread_x<Cfg>();
  constexpr int BK = Cfg::BK;
  const int nk = ke > kb ? (ke - kb + BK - 1) / BK : 0;
  SliceCopier<Cfg::BM, BK, Cfg::THREADS, T, OA> ca(oa, m0, kb, M, vec_a,
                                                    a_k_fast);
  SliceCopier<Cfg::BN, BK, Cfg::THREADS, T, OB> cb(ob, n0, kb, N, vec_b,
                                                    b_k_fast);
  auto load = [&](int t) {  // slices are loaded once each, in order
    float* as = smem + (t % STAGES) * Cfg::STAGE;
    ca.copy(as, oa, kb + t * BK, ke);
    cb.copy(as + BK * Cfg::PA, ob, kb + t * BK, ke);
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < nk) load(t);
    cp_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_wait<STAGES - 2>();  // slice t has landed (this thread's copies)
    __syncthreads();        // ... everyone's, and slot t - 1 is free
    if (t + STAGES - 1 < nk) load(t + STAGES - 1);
    cp_commit();
    const float* as = smem + (t % STAGES) * Cfg::STAGE;
    fma_slice<Cfg>(as, as + BK * Cfg::PA, acc, ty, tx);
  }
  cp_wait<0>();
  __syncthreads();
}

// A shared-memory address of this block as seen from rank `rank` of the
// cluster, and a 16-byte load through it (distributed shared memory).
__device__ __forceinline__ unsigned cluster_addr(unsigned addr, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float4 ld_cluster4(unsigned addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// Sums the cluster's partial tiles and hands each in-range element of C
// to sc(m, n, value) exactly once.  Each block stages its partial tile
// with C's contiguous axis fast (c_n_fast: n, else m; pitch + 4), so that
// the tile reads as runs of 4 along that axis.  Rank q of S then sums the
// q-th 1/S of those runs over ranks 0..S-1, in order, loading a batch of
// runs from every rank before it stores any, so that the loads overlap.
// Every block of the cluster must call it.
template <class Cfg, class SC>
__device__ __forceinline__ void reduce_store(
    float* smem, const float (&acc)[Cfg::TM][Cfg::TN], int m0, int n0, int M,
    int N, bool c_n_fast, const SC& sc) {
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  auto sync = [&] {
    if (S > 1)
      cluster.sync();
    else
      __syncthreads();
  };
  const int tid = threadIdx.x, ty = thread_y<Cfg>(), tx = thread_x<Cfg>();
  // tile[m][n] (pitch BN + 4) or tile[n][m] (pitch BM + 4)
  const int fast = c_n_fast ? Cfg::BN : Cfg::BM;
  const int pitch = fast + 4;
  if (c_n_fast) {
#pragma unroll
    for (int i = 0; i < Cfg::TM; ++i)
#pragma unroll
      for (int g = 0; g < Cfg::TN / 4; ++g)
        *reinterpret_cast<float4*>(smem + acc_row<Cfg>(i, ty) * pitch +
                                   acc_col<Cfg>(4 * g, tx)) =
            make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                        acc[i][4 * g + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < Cfg::TN; ++j)
#pragma unroll
      for (int g = 0; g < Cfg::TM / 4; ++g)
        *reinterpret_cast<float4*>(smem + acc_col<Cfg>(j, tx) * pitch +
                                   acc_row<Cfg>(4 * g, ty)) =
            make_float4(acc[4 * g][j], acc[4 * g + 1][j], acc[4 * g + 2][j],
                        acc[4 * g + 3][j]);
  }
  sync();
  constexpr int RUNS = Cfg::BM * Cfg::BN / 4, BATCH = 4;
  const int per_line = fast / 4;
  const int r1 = (rank + 1) * RUNS / S;
  const unsigned tile = smem_u32(smem);
  for (int r0 = rank * RUNS / S + tid; r0 < r1;
       r0 += BATCH * Cfg::THREADS) {
    unsigned at[BATCH];
    float4 v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int r = min(r0 + u * Cfg::THREADS, r1 - 1);
      at[u] = tile + 4u * (r / per_line * pitch + r % per_line * 4);
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int q = 0; q < S; ++q)
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const float4 w = ld_cluster4(cluster_addr(at[u], q));
        v[u].x += w.x, v[u].y += w.y, v[u].z += w.z, v[u].w += w.w;
      }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int r = r0 + u * Cfg::THREADS;
      const int line = r / per_line, f = r % per_line * 4;
      const int m = m0 + (c_n_fast ? line : f), n = n0 + (c_n_fast ? f : line);
      const int dm = c_n_fast ? 0 : 1, dn = c_n_fast ? 1 : 0;
      if (r < r1) {
        const float e[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (m + k * dm < M && n + k * dn < N)
            sc(m + k * dm, n + k * dn, e[k]);
      }
    }
  }
  sync();  // no block leaves while another reads its tile
}

// ---- the GEMM: C[z] = A[z] @ B[z] (+ bias over N) (ReLU) ----
template <typename T>
struct GemmArgs {
  const T* a;
  const T* b;
  const T* bias;
  T* c;
  int M, N, K;
  int64_t sam, sak, sbk, sbn, scm, scn, sab, sbb, scb;
  int relu, splits, kslice, vec_a, vec_b;
};

template <class Cfg, typename T>
__global__ void __launch_bounds__(Cfg::THREADS, Cfg::MIN_BLOCKS)
    gemm_kernel(const GemmArgs<T> p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int split = blockIdx.x % p.splits;
  const int n0 = blockIdx.x / p.splits * Cfg::BN, m0 = blockIdx.y * Cfg::BM;
  const int64_t z = blockIdx.z;
  const Strided<T> oa{p.a + z * p.sab, p.sam, p.sak};
  const Strided<T> ob{p.b + z * p.sbb, p.sbn, p.sbk};  // (n, k)
  T* c = p.c + z * p.scb;
  float acc[Cfg::TM][Cfg::TN];
#pragma unroll
  for (int i = 0; i < Cfg::TM; ++i)
#pragma unroll
    for (int j = 0; j < Cfg::TN; ++j) acc[i][j] = 0.f;
  const int kb = split * p.kslice, ke = min(p.K, kb + p.kslice);
  mainloop<Cfg, T>(smem, oa, ob, m0, n0, p.M, p.N, kb, ke, p.vec_a, p.vec_b,
                   p.sak == 1, p.sbk == 1, acc);
  reduce_store<Cfg>(smem, acc, m0, n0, p.M, p.N, !(p.scm == 1 && p.scn != 1),
                    [=](int m, int n, float v) {
                      if (p.bias != nullptr) v += to_f32(p.bias[n]);
                      if (p.relu) v = fmaxf(v, 0.f);
                      store_f32(v, c + m * p.scm + n * p.scn);
                    });
}

// Launches `kernel` on a (cols_tiles * splits, rows_tiles, nb) grid in
// clusters of (splits, 1, 1).  Returns a cudaError_t.
template <class Kernel, class Args>
int launch_clustered(Kernel kernel, dim3 grid, int threads, int splits,
                     size_t smem, cudaStream_t stream, const Args& args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args);
  // read (and clear) the last error either way: a refused launch must not
  // be reported again by the next one
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// The planner's choice, checked: a plan that the kernel cannot run is
// refused (cudaErrorInvalidValue), never patched up here.
inline bool plan_ok(int K, int rows, int cols, int nb, int tile, int splits,
                    int kslice) {
  const int bm = tile == 1 ? Tile64::BM : Tile128::BM;  // the others: 128
  return tile >= 0 && tile < NUM_TILES && splits >= 1 &&
         splits <= MAX_SPLITS &&
         kslice >= 1 && int64_t(kslice) * splits >= K &&
         (rows + bm - 1) / bm <= 65535 && nb >= 1 && nb <= 65535 && cols >= 0;
}

// vec == 4 needs the staged axis contiguous and every other stride and
// the base 16-byte aligned (pass 0 for the stride of an axis of extent 1)
inline bool vec_ok(int vec, const void* base, int64_t fast, int64_t s1,
                   int64_t s2) {
  if (vec == 1) return true;
  return vec == 4 && fast == 1 && s1 % 4 == 0 && s2 % 4 == 0 &&
         reinterpret_cast<uintptr_t>(base) % 16 == 0;
}

// static: internal linkage, so that each kernel library that includes
// this header keeps its own `attr`.  (The function-local static of an
// inline function with external linkage is one object for the whole
// process, whichever library defines it: the first library to set its
// kernel's shared-memory limit would leave the others' unset.)
template <class Cfg, typename T>
static int launch_gemm(const GemmArgs<T>& p, int nb, cudaStream_t stream) {
  auto kernel = gemm_kernel<Cfg, T>;
  constexpr int smem = Cfg::RING * 4;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((p.N + Cfg::BN - 1) / Cfg::BN * p.splits,
                  (p.M + Cfg::BM - 1) / Cfg::BM, nb);
  return launch_clustered(kernel, grid, Cfg::THREADS, p.splits, smem,
                          stream, p);
}

template <typename T>
int gemm(const GemmArgs<T>& p, int nb, int tile, cudaStream_t stream) {
  const bool f32 = std::is_same<T, float>::value;
  if (!plan_ok(p.K, p.M, p.N, nb, tile, p.splits, p.kslice) ||
      !(f32 || (p.vec_a == 1 && p.vec_b == 1)) ||
      !vec_ok(p.vec_a, p.a, p.sam, p.K > 1 ? p.sak : 0, nb > 1 ? p.sab : 0) ||
      !vec_ok(p.vec_b, p.b, p.sbn, p.K > 1 ? p.sbk : 0, nb > 1 ? p.sbb : 0))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (tile) {
    case 0: return launch_gemm<Tile128, T>(p, nb, stream);
    case 1: return launch_gemm<Tile64, T>(p, nb, stream);
    case 2: return launch_gemm<Tile128x32, T>(p, nb, stream);
    default: return launch_gemm<Tile128x16, T>(p, nb, stream);
  }
}

}  // namespace sm90
}  // namespace repro
