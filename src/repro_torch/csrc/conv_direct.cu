// Direct convolution as an implicit GEMM, f32, bf16 or f16 in (one dtype
// for x, w, b and y), f32 accumulation, y in the input's dtype:
//   y[n, p, m] = b[m] + sum_{i, j, c} x[n, oh*s + i - pad, ow*s + j - pad, c]
//                                     * w[i, j, c, m]
// for output pixel p = (oh, ow), input in CHW or HWC, output in HWC
// (N, OH*OW, M) or CHW (N, M, OH*OW).  Padding is read as zeros by the
// loader, so the input is never padded in device memory.
//
// Replaces: src/repro/kernels/conv_direct/kernel.py conv_direct_pallas
// (body _conv_kernel).
//
// Bound on the H100: at AlexNet's conv1 and conv2 the layer does
// 2*OH*OW*M*K*K*C operations (0.21e9 and 0.90e9) on 1.9 MB and 3.4 MB
// of input, weights and output, 110 and 260 operations per byte, far
// above the f32 CUDA-core ridge (20): bound by operations.
//
// Design: the TPU kernel keeps the whole padded input strip resident in
// VMEM and does one MXU GEMM per tap.  A Hopper block has at most 227 KB
// of shared memory while AlexNet's conv1 strip alone is 618 KB, so the
// kernel tiles the output and runs the GEMM mainloop of sgemm_sm90.cuh
// (register-blocked, cp.async ring, cluster split-K) over the flattened
// reduction index r = (i*K + j)*C + c, c fastest: w packed (K, K, C, M)
// is then a plain row-major (R, M) matrix.  The gathered operand reads
// through two tables that each block builds once: per pixel row, in the
// copy cursors' registers, the offset of (h0, w0) = (oh*s - pad,
// ow*s - pad) and h0, w0; per r, in shared memory, the offset of
// (i, j, c) and (i, j).  An element is then an add and a bounds test,
// with no division.  With HWC input the run of
// (j, c) for one tap row is contiguous (K*C floats), and neighbouring
// threads copy along it; with CHW input they walk pixels.  For a CHW
// output the product is computed transposed (channels by pixels) so that
// stores stay coalesced.  Images ride on blockIdx.z, the K splits of one
// output tile on the cluster.  The r table covers at most TAP_CHUNK
// entries at a time; a longer split runs the mainloop once per chunk.
// bf16 and f16 operands are gathered through registers, 2 bytes an
// element, and converted to f32 there (16-byte copies need f32).
#include "sgemm_sm90.cuh"

namespace {

using namespace repro::sm90;

constexpr int TAP_CHUNK = 4096;  // r-table entries (32 KB)

template <typename T>
struct ConvArgs {
  const T* x;
  const T* w;
  const T* b;
  T* y;
  int C, H, W, M, K, stride, pad, OH, OW, chw_in;
  int splits, kslice, vec_w;
};

// Element (pixel p, reduction index r) of the input, nullptr in the
// padding.  A cursor holds its pixel's (h0, w0) = (oh*s - pad, ow*s - pad)
// and their offset, resolved once; tap[r - r0] = {offset of (i, j, c),
// i << 16 | j} is the block's table.
template <typename T>
struct Gather {
  static constexpr bool PADS = true;
  const T* base;
  const int2* tap;
  int r0, C, H, W, OW, stride, pad;
  bool chw;
  struct Cursor {
    int off, h0, w0;
  };
  __device__ __forceinline__ Cursor cursor(int p, int) const {
    const int oh = p / OW, ow = p - oh * OW;
    const int h0 = oh * stride - pad, w0 = ow * stride - pad;
    return {chw ? h0 * W + w0 : (h0 * W + w0) * C, h0, w0};
  }
  __device__ __forceinline__ const T* at(const Cursor& c, int r) const {
    const int2 t = tap[r - r0];
    const int h = c.h0 + (t.y >> 16), w = c.w0 + (t.y & 0xffff);
    return (unsigned(h) < unsigned(H) && unsigned(w) < unsigned(W))
               ? base + (c.off + t.x)
               : nullptr;
  }
  __device__ __forceinline__ void advance(Cursor&, int) const {}
};

template <class Cfg, bool CHW_OUT, typename T>
__global__ void __launch_bounds__(Cfg::THREADS, Cfg::MIN_BLOCKS)
    conv_kernel(const ConvArgs<T> p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int2* tap = reinterpret_cast<int2*>(smem + Cfg::RING);
  const int P = p.OH * p.OW, R = p.K * p.K * p.C;
  const int split = blockIdx.x % p.splits;
  const int n0 = blockIdx.x / p.splits * Cfg::BN, m0 = blockIdx.y * Cfg::BM;
  const int rows = CHW_OUT ? p.M : P, cols = CHW_OUT ? P : p.M;
  const bool chw_in = p.chw_in != 0;
  Gather<T> g{p.x + int64_t(blockIdx.z) * p.C * p.H * p.W, tap, 0, p.C,
              p.H, p.W, p.OW, p.stride, p.pad, chw_in};
  const Strided<T> wt{p.w, 1, p.M};  // (m, r) at w[r * M + m]
  float acc[Cfg::TM][Cfg::TN];
#pragma unroll
  for (int i = 0; i < Cfg::TM; ++i)
#pragma unroll
    for (int j = 0; j < Cfg::TN; ++j) acc[i][j] = 0.f;

  const int kb = split * p.kslice, ke = min(R, kb + p.kslice);
  const int kc = p.K * p.C;
  for (int c0 = kb; c0 < ke; c0 += TAP_CHUNK) {
    const int c1 = min(ke, c0 + TAP_CHUNK);
    for (int r = c0 + threadIdx.x; r < c1; r += Cfg::THREADS) {
      const int i = r / kc, rem = r - i * kc, j = rem / p.C,
                c = rem - j * p.C;
      tap[r - c0] = make_int2(chw_in ? (c * p.H + i) * p.W + j
                                     : (i * p.W + j) * p.C + c,
                              (i << 16) | j);
    }
    __syncthreads();
    g.r0 = c0;
    if constexpr (CHW_OUT)  // (M x R) @ (R x P)
      mainloop<Cfg, T>(smem, wt, g, m0, n0, rows, cols, c0, c1, p.vec_w, 1,
                       false, !chw_in, acc);
    else  // (P x R) @ (R x M)
      mainloop<Cfg, T>(smem, g, wt, m0, n0, rows, cols, c0, c1, 1, p.vec_w,
                       !chw_in, false, acc);
  }

  T* y = p.y + int64_t(blockIdx.z) * P * p.M;
  const T* b = p.b;
  reduce_store<Cfg>(smem, acc, m0, n0, rows, cols, true,
                    [=](int r, int c, float v) {
                      if constexpr (CHW_OUT)
                        store_f32(v + to_f32(b[r]), y + int64_t(r) * P + c);
                      else
                        store_f32(v + to_f32(b[c]),
                                  y + int64_t(r) * p.M + c);
                    });
}

template <class Cfg>
constexpr int conv_smem(int taps) {
  return Cfg::RING * 4 + taps * 8;
}

template <class Cfg, bool CHW_OUT, typename T>
int launch_conv(const ConvArgs<T>& p, int nimg, cudaStream_t stream) {
  auto kernel = conv_kernel<Cfg, CHW_OUT, T>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           conv_smem<Cfg>(TAP_CHUNK));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int P = p.OH * p.OW;
  const int rows = CHW_OUT ? p.M : P, cols = CHW_OUT ? P : p.M;
  const dim3 grid((cols + Cfg::BN - 1) / Cfg::BN * p.splits,
                  (rows + Cfg::BM - 1) / Cfg::BM, nimg);
  return launch_clustered(
      kernel, grid, Cfg::THREADS, p.splits,
      conv_smem<Cfg>(p.kslice < TAP_CHUNK ? p.kslice : TAP_CHUNK), stream, p);
}

template <class Cfg, typename T>
int conv(const ConvArgs<T>& p, int nimg, cudaStream_t stream, int chw_out) {
  return chw_out ? launch_conv<Cfg, true>(p, nimg, stream)
                 : launch_conv<Cfg, false>(p, nimg, stream);
}

template <typename T>
int conv_direct(const void* x, const void* w, const void* b, void* y,
                int nimg, int C, int H, int W, int M, int K, int stride,
                int pad, int OH, int OW, int chw_in, int chw_out, int tile,
                int splits, int kslice, int vec_w, void* stream) {
  const int P = OH * OW, R = K * K * C;
  const ConvArgs<T> p{static_cast<const T*>(x), static_cast<const T*>(w),
                      static_cast<const T*>(b), static_cast<T*>(y), C, H, W,
                      M, K, stride, pad, OH, OW, chw_in, splits, kslice,
                      vec_w};
  const bool f32 = std::is_same<T, float>::value;
  if (tile > 1 ||  // built for the 128 x 128 and 64 x 64 tiles only
      !plan_ok(R, chw_out ? M : P, chw_out ? P : M, nimg, tile, splits,
               kslice) ||
      !(f32 || vec_w == 1) || !vec_ok(vec_w, w, 1, R > 1 ? M : 0, 0) ||
      K >= 32768 || int64_t(C) * H * W >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tile == 0 ? conv<Tile128>(p, nimg, s, chw_out)
                   : conv<Tile64>(p, nimg, s, chw_out);
}

}  // namespace

extern "C" {

// tile (0 or 1), splits, kslice, vec_w: the launch planner's choice
// (kernels/matmul/plan.py); vec_w 4 needs f32, M % 4 == 0 and w 16-byte
// aligned.
int repro_conv_direct(const void* x, const void* w, const void* b, void* y,
                      int nimg, int C, int H, int W, int M, int K,
                      int stride, int pad, int OH, int OW, int chw_in,
                      int chw_out, int tile, int splits, int kslice,
                      int vec_w, void* stream) {
  return conv_direct<float>(x, w, b, y, nimg, C, H, W, M, K, stride, pad, OH,
                            OW, chw_in, chw_out, tile, splits, kslice, vec_w,
                            stream);
}

// The same for bf16 and f16 operands (vec_w = 1).
int repro_conv_direct_bf16(const void* x, const void* w, const void* b,
                           void* y, int nimg, int C, int H, int W, int M,
                           int K, int stride, int pad, int OH, int OW,
                           int chw_in, int chw_out, int tile, int splits,
                           int kslice, int vec_w, void* stream) {
  return conv_direct<__nv_bfloat16>(x, w, b, y, nimg, C, H, W, M, K, stride,
                                    pad, OH, OW, chw_in, chw_out, tile,
                                    splits, kslice, vec_w, stream);
}

int repro_conv_direct_f16(const void* x, const void* w, const void* b,
                          void* y, int nimg, int C, int H, int W, int M,
                          int K, int stride, int pad, int OH, int OW,
                          int chw_in, int chw_out, int tile, int splits,
                          int kslice, int vec_w, void* stream) {
  return conv_direct<__half>(x, w, b, y, nimg, C, H, W, M, K, stride, pad, OH,
                             OW, chw_in, chw_out, tile, splits, kslice, vec_w,
                             stream);
}

}  // extern "C"
