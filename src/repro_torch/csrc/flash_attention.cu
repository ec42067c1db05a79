// Flash attention: O = softmax(mask(softcap(Q K^T * scale))) V with an
// online softmax over KV tiles, f32, bf16 or f16 in (one dtype for q, k,
// v and o), f32 arithmetic, the output in the input's dtype.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py
// flash_attention_pallas (body _flash_kernel).  It computes what that
// body computes, edges included:
//   - q is scaled in f32 before the product;
//   - softcap: s = cap * tanh(s / cap), before masking;
//   - mask = k_pos < lk_valid, and q_pos >= k_pos if causal, and
//     q_pos - k_pos < window if window > 0; masked logits are
//     NEG_INF = -1e30 and p = mask ? exp(s - m) : 0;
//   - GQA: query head h reads kv head h / (Hq / Hkv);
//   - KV tiles that the mask empties for the whole query tile are skipped
//     (they would add nothing);
//   - a row whose every key is masked has l = 0 and outputs 0, not NaN.
// Head-major (B, H, L, D) and sequence-major (B, L, H, D) operands are
// both read through strides, with no transpose.  Any head dim D >= 1.
//
// Bound on the H100: Q K^T and P V do 4 * B*Hq*Lq*Lk*D operations (f32
// FMA on the CUDA cores, 67e12/s) on the bytes of q, k, v and o.  At the
// calibration sweep's shapes (Hq = 4, D = 64, L = 1024 or 256) that is
// 64 to 256 operations per byte, far above the f32 ridge of 20: bound by
// operations.  True f32 throughout (no TF32); the softmax runs in base 2
// (one ex2 per logit, log2 e folded in after the scale and the softcap;
// ex2.approx is within 2 ulp, as expf is).  With the softmax's branches
// out of the per-logit loop (the softcap tested once per tile, the mask
// only on tiles that a mask cuts), a tile costs little beyond its FMAs.
//
// Design, for the 132 SMs and their f32 FMA rate:
// * Fill the card: a cluster KV split.  The launch planner
//   (kernels/flash_attention/plan.py) picks the query tile BQ (32 or 64
//   rows) and a split S <= 8: the S blocks of a thread-block cluster share
//   one query tile, and each reduces a contiguous run of the KV tiles its
//   rows can see into a partial (m, l, acc).  After cluster.sync() rank r
//   merges the r-th 1/S of the tile over every rank's partial through
//   distributed shared memory, in rank order: m = max m_q,
//   l = sum l_q e^(m_q - m), acc = sum acc_q e^(m_q - m), out = acc / l.
//   So a call is one launch with no workspace, and a repeated call gives
//   the same bits.  A rank with no tile (causal or window masks) holds
//   m = -1e30, l = 0 and weighs nothing; a row no key reaches stays 0.
// * Register blocking with float4 fragments.  A warp is 4 row groups by 8
//   column groups of threads; a thread holds TM (4, or 2 at D > 128)
//   query rows by BKV / 8 keys of logits and the same rows by D / 8
//   output columns.  Q, K and V sit row-major in shared memory (pitch
//   D + 4) and P row-major (pitch BKV + 8), so each fragment read is a
//   float4 along the contiguous axis and a warp's read touches at most 8
//   distinct float4s in distinct banks: one wavefront.  At D = 64 a
//   thread does 128 FMAs per 12 float4 reads, in both products.
// * A cp.async ring of STAGES (2 or 3) K and V tiles, loaded STAGES - 1
//   ahead, with 16-byte copies where the head dim is contiguous and
//   16-byte aligned (4-byte copies elsewhere).  Ragged Lk and the padded
//   columns are zero-filled by the copy (src-size 0).  bf16 and f16 are
//   loaded through registers and converted there; the mainloop is the
//   same f32 one.  One block barrier per KV tile: P goes from the softmax
//   to the P V product through a tile of rows that one warp owns, so a
//   __syncwarp orders it.  The row statistics live in registers, reduced
//   over the 8 threads of a row group with shuffles.
// * Shared memory sized by D.  D is padded to the smallest instantiated
//   width DP in {32, 64, 128, 256} that holds it, the extra columns
//   zero-filled by the copy (zeros change no logit; their output columns
//   are not stored), at a cost of DP / D in FMAs (2 x at D = 16, 1.14 x
//   at D = 112).  The key tile (64 keys up to DP = 64, 32 beyond) and the
//   stages shrink as DP grows, so every instantiation fits in 227 KB:
//   from 67.5 KB (DP = 32, BQ = 32) to 205 KB (DP = 256, BQ = 64).
// * D > 256 (no configuration of the reference reaches it, but it takes
//   any D): the output's D is cut into slices of 256 on grid y, and each
//   block recomputes the logits, Q K^T accumulated over D in slices of
//   256 through the same Q and K tiles, with no ring (two barriers per
//   slice).  That costs D / 256 times the Q K^T work and Q reloads per
//   KV tile, against one block at D <= 256.
#include "sgemm_sm90.cuh"  // cp.async, cluster and dtype helpers

namespace {

using namespace repro::sm90;

constexpr float NEG_INF = -1e30f;
constexpr int MAX_DP = 256;  // the widest instantiation

// One instantiation: padded head dim DP and query tile BQ.
template <int DP_, int BQ_>
struct Cfg {
  static constexpr int DP = DP_, BQ = BQ_;
  static constexpr int WX = 8, WY = 4;            // a warp's thread grid
  static constexpr int TM = DP <= 128 ? 4 : 2;    // query rows per thread
  static constexpr int BKV = DP <= 64 ? 64 : 32;  // keys per KV tile
  static constexpr int STAGES = DP <= 32 ? 3 : 2;
  static constexpr int CJ = BKV / WX;        // logit columns per thread
  static constexpr int DJ = DP / WX;         // output columns per thread
  static constexpr int NW = BQ / (WY * TM);  // warps
  static constexpr int THREADS = NW * 32;
  static constexpr int PQ = DP + 4;    // pitch of the Q, K and V tiles
  static constexpr int PP = BKV + 8;   // pitch of the P tile
  static constexpr int Q_FLOATS = BQ * PQ;
  static constexpr int KV_FLOATS = BKV * PQ;  // one K or V tile
  static constexpr int RING = STAGES * 2 * KV_FLOATS;
  static constexpr int P_FLOATS = BQ * PP;
  static constexpr int SMEM = 4 * (Q_FLOATS + RING + P_FLOATS);
  static_assert(NW * WY * TM == BQ && DJ % 4 == 0 && CJ >= 1,
                "whole warps, float4 output fragments");
  static_assert(BQ * DP / 4 % THREADS == 0 && BKV * DP / 4 % THREADS == 0,
                "every thread copies as many 16-byte runs of a tile");
  static_assert(Q_FLOATS + 2 * BQ <= RING, "the merge's tile fits the ring");
  static_assert(SMEM <= 232448, "227 KB of shared memory per block");
};

// A float of another block of the cluster (distributed shared memory).
__device__ __forceinline__ float ld_cluster(unsigned addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}
// 2^x, flushing results below 2^-126 to 0 (one MUFU.EX2; relative error
// 2^-22).  p under 2^-126 weighs less than an f32 ulp of the row's sum,
// which is at least 1.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Elements [0, n) of the run of 4 at src as f32, zeros beyond; vec: the
// run is aligned to 4 elements (one 16- or 8-byte load when n == 4).
template <typename T>
__device__ __forceinline__ float4 load4(const T* src, int n, bool vec) {
  float f[4];
  if (vec && n == 4) {
    if constexpr (std::is_same<T, float>::value) {
      return *reinterpret_cast<const float4*>(src);
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(src);
      const T* h = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = to_f32(h[e]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = e < n ? to_f32(src[e]) : 0.f;
  }
  return make_float4(f[0], f[1], f[2], f[3]);
}

// Copies rows [r0, r0 + ROWS) by columns [d0, d0 + DP) of a (rows, D)
// operand (row stride srow, columns contiguous) into s (pitch PQ) as f32;
// rows at or past rlim and columns at or past D are zero.  f32 goes by
// cp.async (the caller commits), 16 bytes a copy where vec, else 4; the
// 2-byte types through registers.
template <class C, int ROWS, typename T>
__device__ __forceinline__ void copy_tile(float* s, const T* base,
                                          int64_t srow, int r0, int rlim,
                                          int d0, int D, bool vec) {
  constexpr int C4 = C::DP / 4, N = ROWS * C4 / C::THREADS;
  constexpr int RSTEP = C::THREADS / C4;  // rows between a thread's runs
  static_assert(C::THREADS % C4 == 0, "a thread keeps its column");
  const int r = threadIdx.x / C4, c = threadIdx.x % C4 * 4;
  const int gd = d0 + c, nd = max(0, min(4, D - gd));
  const T* src = base + (r0 + r) * srow + gd;
  float* dst = s + r * C::PQ + c;
  if (std::is_same<T, float>::value && vec) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int n = r0 + r + i * RSTEP < rlim ? nd : 0;
      cp_async16(dst + i * RSTEP * C::PQ, n ? src + i * RSTEP * srow : base,
                 4 * n);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int n = r0 + r + i * RSTEP < rlim ? nd : 0;
    const T* at = n ? src + i * RSTEP * srow : base;
    float* to = dst + i * RSTEP * C::PQ;
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        cp_async4(to + u, u < n ? at + u : base, u < n ? 4 : 0);
    } else {
      *reinterpret_cast<float4*>(to) = load4(at, n, vec);
    }
  }
}

// The query tile, scaled in f32, through registers.
template <class C, typename T>
__device__ __forceinline__ void load_q(float* s, const T* base, int64_t srow,
                                       int r0, int rlim, int d0, int D,
                                       bool vec, float scale) {
  constexpr int C4 = C::DP / 4;
#pragma unroll
  for (int i = 0; i < C::BQ * C4 / C::THREADS; ++i) {
    const int e = threadIdx.x + i * C::THREADS;
    const int r = e / C4, c = e % C4 * 4;
    const int gr = r0 + r, gd = d0 + c;
    const int n = gr < rlim ? max(0, min(4, D - gd)) : 0;
    float4 f = load4(n ? base + gr * srow + gd : base, n, vec);
    f.x *= scale, f.y *= scale, f.z *= scale, f.w *= scale;
    *reinterpret_cast<float4*>(s + r * C::PQ + c) = f;
  }
}

// s += Q K^T over the DP columns of the tiles: row0 + i * WY by key
// j * WX + tx.
template <class C>
__device__ __forceinline__ void qk(const float* Qs, const float* Ks,
                                   float (&s)[C::TM][C::CJ], int row0,
                                   int tx) {
#pragma unroll 2
  for (int d = 0; d < C::DP; d += 4) {
    float4 qa[C::TM], kb[C::CJ];
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
      qa[i] = *reinterpret_cast<const float4*>(
          Qs + (row0 + i * C::WY) * C::PQ + d);
#pragma unroll
    for (int j = 0; j < C::CJ; ++j)
      kb[j] = *reinterpret_cast<const float4*>(
          Ks + (j * C::WX + tx) * C::PQ + d);
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::CJ; ++j)
        s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::CJ; ++j)
        s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::CJ; ++j)
        s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::CJ; ++j)
        s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
  }
}

// Folds one tile of logits (keys k0 + j * WX + tx) into the running max m,
// sum l and accumulator of each row, and writes p to the P tile.  The
// softmax runs in base 2: m and the logits are kept times log2(e), so
// that p = 2^(s log2 e - m) is one ex2 (the same value as e^(s - m'),
// within an ulp of the exponent).  EDGE: some key of the tile may be
// masked for some row (ragged Lk, the causal diagonal, the window's edge);
// else the mask is skipped.  The rows' reductions are interleaved.
template <class C, bool EDGE>
__device__ __forceinline__ void softmax_tile(
    float (&s)[C::TM][C::CJ], float (&m)[C::TM], float (&l)[C::TM],
    float (&acc)[C::TM][C::DJ], float* Ps, int row0, int tx, int q0, int k0,
    int lk_valid, int causal, int window, float softcap) {
  constexpr float LOG2E = 1.4426950408889634f;
  float mx[C::TM], sum[C::TM];
  unsigned okb[C::TM];  // EDGE: bit j set where key j is seen
  if (softcap > 0.f) {
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::CJ; ++j)
        s[i][j] = softcap * tanhf(s[i][j] / softcap);
  }
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int qp = q0 + row0 + i * C::WY;
    mx[i] = NEG_INF;
    okb[i] = 0u;
#pragma unroll
    for (int j = 0; j < C::CJ; ++j) {
      float x = s[i][j] * LOG2E;
      if constexpr (EDGE) {
        const int kp = k0 + j * C::WX + tx;
        const bool ok = kp < lk_valid && (!causal || qp >= kp) &&
                        (window <= 0 || qp - kp < window);
        x = ok ? x : NEG_INF;
        okb[i] |= unsigned(ok) << j;
      }
      s[i][j] = x;
      mx[i] = fmaxf(mx[i], x);
    }
  }
#pragma unroll
  for (int off = C::WX / 2; off > 0; off /= 2)
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int row = row0 + i * C::WY;
    mx[i] = fmaxf(m[i], mx[i]);  // the new running max
    sum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < C::CJ; ++j) {
      const bool ok = !EDGE || (okb[i] >> j & 1u);
      const float p = ok ? ex2(s[i][j] - mx[i]) : 0.f;
      Ps[row * C::PP + j * C::WX + tx] = p;
      sum[i] += p;
    }
  }
#pragma unroll
  for (int off = C::WX / 2; off > 0; off /= 2)
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], off);
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const float alpha = ex2(m[i] - mx[i]);
    l[i] = l[i] * alpha + sum[i];
    m[i] = mx[i];
#pragma unroll
    for (int j = 0; j < C::DJ; ++j) acc[i][j] *= alpha;
  }
}

// acc += P V over the tile's keys; output column (g * WX + tx) * 4 + e of
// the DP is acc[.][4 * g + e].
template <class C>
__device__ __forceinline__ void pv(const float* Ps, const float* Vs,
                                   float (&acc)[C::TM][C::DJ], int row0,
                                   int tx) {
#pragma unroll 1
  for (int kk = 0; kk < C::BKV; kk += 4) {
    float4 pa[C::TM];
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
      pa[i] = *reinterpret_cast<const float4*>(
          Ps + (row0 + i * C::WY) * C::PP + kk);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* vr = Vs + (kk + e) * C::PQ;
#pragma unroll
      for (int g = 0; g < C::DJ / 4; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vr + (g * C::WX + tx) * 4);
#pragma unroll
        for (int i = 0; i < C::TM; ++i) {
          const float p = e == 0 ? pa[i].x
                          : e == 1 ? pa[i].y
                          : e == 2 ? pa[i].z
                                   : pa[i].w;
          acc[i][4 * g] = fmaf(p, vv.x, acc[i][4 * g]);
          acc[i][4 * g + 1] = fmaf(p, vv.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(p, vv.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(p, vv.w, acc[i][4 * g + 3]);
        }
      }
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Hq, group, Lq, lk_valid, D, slices;
  int64_t sqb, sqh, sql, skb, skh, skl, svb, svh, svl, sob, soh, sol;
  float scale, softcap;
  int causal, window, vec;
};

// Grid: (query tiles * S, Hq * slices, B), clusters of (S, 1, 1).
// SLICED: D > DP, the output's columns [slice * DP, + DP) on grid y.
template <class C, typename T, bool SLICED>
__global__ void __launch_bounds__(C::THREADS, 1) flash_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][PQ], scaled
  float* ring = Qs + C::Q_FLOATS;  // STAGES x {K [BKV][PQ], V [BKV][PQ]}
  float* Ps = ring + C::RING;      // [BQ][PP]

  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid % 32;
  const int tx = lane % C::WX;
  // this thread's rows: row0 + i * WY; a warp owns WY * TM whole rows
  const int row0 = tid / 32 * C::WY * C::TM + lane / C::WX;
  const int q0 = blockIdx.x / S * C::BQ;
  const int h = blockIdx.y / a.slices;
  const int dso = blockIdx.y % a.slices * C::DP;  // first output column
  const int b = blockIdx.z;
  const int hk = h / a.group;
  const T* q = static_cast<const T*>(a.q) + b * a.sqb + h * a.sqh;
  const T* k = static_cast<const T*>(a.k) + b * a.skb + hk * a.skh;
  const T* v = static_cast<const T*>(a.v) + b * a.svb + hk * a.svh;
  T* o = static_cast<T*>(a.o) + b * a.sob + h * a.soh;
  const bool vec = a.vec != 0;

  // the KV tiles that any row of this query tile can see, and this rank's
  // contiguous run of them
  const int q_last = min(q0 + C::BQ, a.Lq) - 1;
  int k_end = a.lk_valid;
  if (a.causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, q0 - a.window + 1) / C::BKV * C::BKV;
  const int ntiles =
      k_end > k_begin ? (k_end - k_begin + C::BKV - 1) / C::BKV : 0;
  const int t0 = rank * ntiles / S, nt = (rank + 1) * ntiles / S - t0;
  const int kb0 = k_begin + t0 * C::BKV;
  // whether a mask may cut the tile at key kt for some row of the block
  auto edge = [&](int kt) {
    return kt + C::BKV > a.lk_valid || (a.causal && kt + C::BKV - 1 > q0) ||
           (a.window > 0 && q_last - kt >= a.window);
  };

  float m[C::TM], l[C::TM], acc[C::TM][C::DJ];
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < C::DJ; ++j) acc[i][j] = 0.f;
  }

  if constexpr (!SLICED) {
    auto load_kv = [&](int t) {  // tile t of this rank, into slot t % STAGES
      float* ks = ring + t % C::STAGES * 2 * C::KV_FLOATS;
      const int kt = kb0 + t * C::BKV;
      copy_tile<C, C::BKV>(ks, k, a.skl, kt, a.lk_valid, 0, a.D, vec);
      copy_tile<C, C::BKV>(ks + C::KV_FLOATS, v, a.svl, kt, a.lk_valid, 0,
                           a.D, vec);
    };
#pragma unroll
    for (int t = 0; t < C::STAGES - 1; ++t) {
      if (t < nt) load_kv(t);
      cp_commit();
    }
    load_q<C>(Qs, q, a.sql, q0, a.Lq, 0, a.D, vec, a.scale);
    for (int t = 0; t < nt; ++t) {
      cp_wait<C::STAGES - 2>();  // tile t has landed (this thread's copies)
      __syncthreads();           // ... everyone's, and slot t - 1 is free
      if (t + C::STAGES - 1 < nt) load_kv(t + C::STAGES - 1);
      cp_commit();
      const float* ks = ring + t % C::STAGES * 2 * C::KV_FLOATS;
      float s[C::TM][C::CJ];
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
#pragma unroll
        for (int j = 0; j < C::CJ; ++j) s[i][j] = 0.f;
      qk<C>(Qs, ks, s, row0, tx);
      const int kt = kb0 + t * C::BKV;
      if (edge(kt))
        softmax_tile<C, true>(s, m, l, acc, Ps, row0, tx, q0, kt, a.lk_valid,
                              a.causal, a.window, a.softcap);
      else
        softmax_tile<C, false>(s, m, l, acc, Ps, row0, tx, q0, kt,
                               a.lk_valid, a.causal, a.window, a.softcap);
      __syncwarp();  // P rows are this warp's own
      pv<C>(Ps, ks + C::KV_FLOATS, acc, row0, tx);
    }
  } else {
    for (int t = 0; t < nt; ++t) {
      const int kt = kb0 + t * C::BKV;
      float s[C::TM][C::CJ];
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
#pragma unroll
        for (int j = 0; j < C::CJ; ++j) s[i][j] = 0.f;
      for (int dc = 0; dc < a.D; dc += C::DP) {
        __syncthreads();  // the previous slice's readers are done
        copy_tile<C, C::BKV>(ring, k, a.skl, kt, a.lk_valid, dc, a.D, vec);
        cp_commit();
        load_q<C>(Qs, q, a.sql, q0, a.Lq, dc, a.D, vec, a.scale);
        cp_wait<0>();
        __syncthreads();
        qk<C>(Qs, ring, s, row0, tx);
      }
      softmax_tile<C, true>(s, m, l, acc, Ps, row0, tx, q0, kt, a.lk_valid,
                            a.causal, a.window, a.softcap);
      // the V tile's last readers finished before this tile's barriers
      copy_tile<C, C::BKV>(ring + C::KV_FLOATS, v, a.svl, kt, a.lk_valid,
                           dso, a.D, vec);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      pv<C>(Ps, ring + C::KV_FLOATS, acc, row0, tx);
    }
  }

  if (S == 1) {
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      const int qp = q0 + row0 + i * C::WY;
      if (qp >= a.Lq) continue;
      const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
      for (int j = 0; j < C::DJ; ++j) {
        const int d = dso + (j / 4 * C::WX + tx) * 4 + j % 4;
        if (d < a.D) store_f32(acc[i][j] / li, o + qp * a.sol + d);
      }
    }
    return;
  }

  // ---- merge the cluster's partials (distributed shared memory) ----
  cp_wait<0>();
  __syncthreads();  // the ring is idle
  float* Os = ring;              // [BQ][PQ]
  float* Ms = ring + C::Q_FLOATS;  // [BQ]
  float* Ls = Ms + C::BQ;          // [BQ]
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int row = row0 + i * C::WY;
#pragma unroll
    for (int g = 0; g < C::DJ / 4; ++g)
      *reinterpret_cast<float4*>(Os + row * C::PQ + (g * C::WX + tx) * 4) =
          make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                      acc[i][4 * g + 3]);
    if (tx == 0) Ms[row] = m[i], Ls[row] = l[i];
  }
  cluster.sync();
  constexpr int C4 = C::DP / 4, RUNS = C::BQ * C4;
  const int r1 = (rank + 1) * RUNS / S;
  for (int r = rank * RUNS / S + tid; r < r1; r += C::THREADS) {
    const int row = r / C4, c = r % C4 * 4;
    const unsigned ao = smem_u32(Os + row * C::PQ + c);
    const unsigned am = smem_u32(Ms + row), al = smem_u32(Ls + row);
    // every rank's partial loaded at once, then summed in rank order
    float mq[MAX_SPLITS], lq[MAX_SPLITS], mx = NEG_INF;
    float4 aq[MAX_SPLITS];
#pragma unroll
    for (int u = 0; u < MAX_SPLITS; ++u)
      if (u < S) {
        mq[u] = ld_cluster(cluster_addr(am, u));
        lq[u] = ld_cluster(cluster_addr(al, u));
        aq[u] = ld_cluster4(cluster_addr(ao, u));
      }
#pragma unroll
    for (int u = 0; u < MAX_SPLITS; ++u)
      if (u < S) mx = fmaxf(mx, mq[u]);
    float lsum = 0.f;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < MAX_SPLITS; ++u)
      if (u < S) {
        const float wgt = ex2(mq[u] - mx);  // m is in base 2
        lsum = fmaf(lq[u], wgt, lsum);
        const float4 x = aq[u];
        sum.x = fmaf(x.x, wgt, sum.x);
        sum.y = fmaf(x.y, wgt, sum.y);
        sum.z = fmaf(x.z, wgt, sum.z);
        sum.w = fmaf(x.w, wgt, sum.w);
      }
    const int qp = q0 + row;
    if (qp < a.Lq) {
      const float li = lsum == 0.f ? 1.f : lsum;
      const float e[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (dso + c + u < a.D)
          store_f32(e[u] / li, o + qp * a.sol + dso + c + u);
    }
  }
  cluster.sync();  // no block leaves while another reads its partial
}

// Sets the instantiation's shared-memory limit once (a function-local
// static, internal to this library), then launches in clusters of
// (splits, 1, 1).  Returns a cudaError_t.
template <class C, typename T, bool SLICED>
int launch(const Args& a, int B, int splits, cudaStream_t stream) {
  auto kernel = flash_kernel<C, T, SLICED>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((a.Lq + C::BQ - 1) / C::BQ * splits, a.Hq * a.slices, B);
  return launch_clustered(kernel, grid, C::THREADS, splits, C::SMEM, stream,
                          a);
}

template <typename T>
int dispatch(const Args& a, int B, int dp, int bq, int splits,
             cudaStream_t st) {
  if (a.slices > 1) return launch<Cfg<256, 32>, T, true>(a, B, splits, st);
  const bool wide = bq == 64;
  switch (dp) {
    case 32:
      return wide ? launch<Cfg<32, 64>, T, false>(a, B, splits, st)
                  : launch<Cfg<32, 32>, T, false>(a, B, splits, st);
    case 64:
      return wide ? launch<Cfg<64, 64>, T, false>(a, B, splits, st)
                  : launch<Cfg<64, 32>, T, false>(a, B, splits, st);
    case 128:
      return wide ? launch<Cfg<128, 64>, T, false>(a, B, splits, st)
                  : launch<Cfg<128, 32>, T, false>(a, B, splits, st);
    default:
      return wide ? launch<Cfg<256, 64>, T, false>(a, B, splits, st)
                  : launch<Cfg<256, 32>, T, false>(a, B, splits, st);
  }
}

// 16-byte (f32) or 8-byte (2-byte types) runs along D: D a multiple of
// 4 and every stride and base aligned to 4 elements
bool aligned4(const void* p, int esize, int64_t s0, int64_t s1, int64_t s2) {
  return reinterpret_cast<uintptr_t>(p) % (4 * esize) == 0 && s0 % 4 == 0 &&
         s1 % 4 == 0 && s2 % 4 == 0;
}

}  // namespace

extern "C" {

// Strides are in elements; the head dim is contiguous in every operand.
// dtype: 0 f32, 1 bf16, 2 f16.  dp (32, 64, 128 or 256: the padded head
// dim, >= D unless D > 256, which runs in slices of 256 at bq 32), bq (32
// or 64) and splits (1..8): the launch planner's choice
// (kernels/flash_attention/plan.py), refused with cudaErrorInvalidValue
// where the kernel cannot run it.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* o, int B, int Hq, int Hkv, int Lq,
                          int lk_valid, int D, int64_t sqb, int64_t sqh,
                          int64_t sql, int64_t skb, int64_t skh, int64_t skl,
                          int64_t svb, int64_t svh, int64_t svl, int64_t sob,
                          int64_t soh, int64_t sol, float scale, int causal,
                          int window, float softcap, int dtype, int dp,
                          int bq, int splits, void* stream) {
  const int slices = D > MAX_DP ? (D + MAX_DP - 1) / MAX_DP : 1;
  const bool fits = dp == 32 || dp == 64 || dp == 128 || dp == 256;
  if (!fits || (bq != 32 && bq != 64) || splits < 1 ||
      splits > MAX_SPLITS || D < 1 || (slices == 1 && D > dp) ||
      (slices > 1 && (dp != MAX_DP || bq != 32)) || Hkv < 1 ||
      Hq % Hkv != 0 || int64_t(Hq) * slices > 65535 || B < 1 || B > 65535 ||
      Lq < 1 || lk_valid < 0 || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int esize = dtype == 0 ? 4 : 2;
  const int vec = D % 4 == 0 && aligned4(q, esize, sqb, sqh, sql) &&
                  aligned4(k, esize, skb, skh, skl) &&
                  aligned4(v, esize, svb, svh, svl);
  const Args a{q, k, v, o, Hq, Hq / Hkv, Lq, lk_valid, D, slices,
               sqb, sqh, sql, skb, skh, skl, svb, svh, svl, sob, soh, sol,
               scale, softcap, causal, window, vec};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(a, B, dp, bq, splits, st);
    case 1: return dispatch<__nv_bfloat16>(a, B, dp, bq, splits, st);
    default: return dispatch<__half>(a, B, dp, bq, splits, st);
  }
}

}  // extern "C"
