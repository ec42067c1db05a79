// Flash attention: O = softmax(mask(softcap(Q K^T * scale))) V with an
// online softmax over KV tiles, f32 or bf16 in, f32 accumulation, the
// output in the input's dtype.
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
// both read through strides, with no transpose.
//
// Bound on the H100: Q K^T and P V do 4 * B*Hq*Lq*Lk*D operations (f32
// FMA on the CUDA cores, 67e12/s) on the bytes of q, k, v and o.  At the
// calibration sweep's shapes (Hq = 4, D = 64, L = 1024 or 256) that is
// 64 to 256 operations per byte, far above the f32 ridge of 20: bound by
// operations.
//
// Design: one block of 256 threads per (query tile of 64 rows, head,
// batch).  The TPU kernel's sequential KV grid axis becomes a loop
// inside the block: each step stages a 64-key tile of K (transposed) and
// V in shared memory, computes the 64 x 64 logits with a 4 x 4 register
// tile per thread, and folds them into the running max m, running sum l
// and the f32 accumulator of each query row, all in registers.  The 16
// threads that share a query row reduce its max and sum with warp
// shuffles.  Ragged Lq and Lk are masked in the kernel (the reference
// pads them to block multiples).  Plain f32 FMA; no tensor cores yet.
// Templated on the head dim (64, 128, 256); at 256 the block uses
// 214 KB of shared memory and runs one block per SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BKV = 64;      // keys per KV tile
constexpr int THREADS = 256;
constexpr int RX = 16;       // threads sharing one query row
constexpr int RI = BQ / RX;  // query rows per thread (4)
constexpr int CJ = BKV / RX; // logit columns per thread (4)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Hq, group, Lq, lk_valid;
  int64_t sqb, sqh, sql, skb, skh, skl, svb, svh, svl, sob, soh, sol;
  float scale, softcap;
  int causal, window;
};

template <int D>
constexpr size_t smem_bytes() {
  // Qs[BQ][D+1], Kt[D][BKV+1], Vs[BKV][D], Ps[BQ][BKV+1]
  return sizeof(float) * (BQ * (D + 1) + D * (BKV + 1) + BKV * D +
                          BQ * (BKV + 1));
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS) flash_kernel(Args a) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][D + 1], scaled
  float* Kt = Qs + BQ * (D + 1);       // [D][BKV + 1]
  float* Vs = Kt + D * (BKV + 1);      // [BKV][D]
  float* Ps = Vs + BKV * D;            // [BQ][BKV + 1]

  const int tid = threadIdx.x;
  const int tx = tid % RX;
  const int ty = tid / RX;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / a.group;
  const T* q = static_cast<const T*>(a.q) + b * a.sqb + h * a.sqh;
  const T* k = static_cast<const T*>(a.k) + b * a.skb + hk * a.skh;
  const T* v = static_cast<const T*>(a.v) + b * a.svb + hk * a.svh;
  T* o = static_cast<T*>(a.o) + b * a.sob + h * a.soh;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int qp = q0 + r;
    Qs[r * (D + 1) + d] =
        qp < a.Lq ? to_f32(q[qp * a.sql + d]) * a.scale : 0.f;
  }

  float m[RI], l[RI], acc[RI][D / RX];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D / RX; ++j) acc[i][j] = 0.f;
  }

  // the KV range that any row of this query tile can see
  const int q_last = min(q0 + BQ, a.Lq) - 1;
  int k_end = a.lk_valid;
  if (a.causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, q0 - a.window + 1) / BKV * BKV;

  for (int k0 = k_begin; k0 < k_end; k0 += BKV) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BKV * D; e += THREADS) {
      const int kk = e / D, d = e % D;
      const int kp = k0 + kk;
      const bool in = kp < a.lk_valid;
      Kt[d * (BKV + 1) + kk] = in ? to_f32(k[kp * a.skl + d]) : 0.f;
      Vs[kk * D + d] = in ? to_f32(v[kp * a.svl + d]) : 0.f;
    }
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = Qs[(ty + RX * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = Kt[d * (BKV + 1) + tx + RX * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qp = q0 + ty + RX * i;
      bool ok[CJ];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kp = k0 + tx + RX * j;
        float x = s[i][j];
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        ok[j] = kp < a.lk_valid && (!a.causal || qp >= kp) &&
                (a.window <= 0 || qp - kp < a.window);
        s[i][j] = ok[j] ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = RX / 2; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + RX * i) * (BKV + 1) + tx + RX * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = RX / 2; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < D / RX; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      float pv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = Ps[(ty + RX * i) * (BKV + 1) + kk];
#pragma unroll
      for (int j = 0; j < D / RX; ++j) {
        const float vv = Vs[kk * D + tx + RX * j];
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qp = q0 + ty + RX * i;
    if (qp >= a.Lq) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int j = 0; j < D / RX; ++j)
      store(acc[i][j] * inv, o + qp * a.sol + tx + RX * j);
  }
}

template <int D, typename T>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // above 48 KB a block's dynamic shared memory must be allowed first
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + BQ - 1) / BQ, a.Hq, B);
  flash_kernel<D, T><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<64, T>(a, B, stream);
    case 128: return launch<128, T>(a, B, stream);
    case 256: return launch<256, T>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Strides are in elements; the head dim is contiguous in every operand.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* o, int B, int Hq, int Hkv, int Lq,
                          int lk_valid, int D, int64_t sqb, int64_t sqh,
                          int64_t sql, int64_t skb, int64_t skh, int64_t skl,
                          int64_t svb, int64_t svh, int64_t svl, int64_t sob,
                          int64_t soh, int64_t sol, float scale, int causal,
                          int window, float softcap, int bf16,
                          void* stream) {
  Args a{q, k, v, o, Hq, Hq / Hkv, Lq, lk_valid, sqb, sqh, sql, skb, skh,
         skl, svb, svh, svl, sob, soh, sol, scale, softcap, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_d<__nv_bfloat16>(a, B, D, st)
              : launch_d<float>(a, B, D, st);
}

}  // extern "C"
