// Direct convolution as an implicit GEMM, f32 in, f32 accumulation:
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
// VMEM and does one MXU GEMM per tap.  Here a block has at most 227 KB
// of shared memory while AlexNet's conv1 strip alone is 618 KB, so the
// kernel tiles the output instead: 64 output pixels by 64 output
// channels per block, and the contraction over the flattened (tap,
// channel) index r = (i*K + j)*C + c loops inside the block in chunks
// of 16 (tile_gemm.cuh).  Each chunk stages only its gathered input
// window and its slice of w -- which, packed (K, K, C, M), is a plain
// row-major (K*K*C, M) matrix.  Flattening taps with channels wastes
// no lanes on conv1's C = 3.  For a CHW output the product is computed
// transposed (channels by pixels) so that stores stay coalesced; the
// TPU kernel's CHW prologue and epilogue become the loader's and the
// store's index maps.  Images ride on blockIdx.z.
#include "tile_gemm.cuh"

namespace {

struct InputGather {
  const float* x;
  int C, H, W, K, stride, pad, OW;
  bool chw;
  __device__ __forceinline__ float operator()(int p, int r) const {
    const int oh = p / OW, ow = p - oh * OW;
    const int kc = K * C;
    const int i = r / kc;
    const int rem = r - i * kc;
    const int j = rem / C, c = rem - j * C;
    const int h = oh * stride + i - pad, w = ow * stride + j - pad;
    if (h < 0 || h >= H || w < 0 || w >= W) return 0.f;
    return chw ? x[(int64_t(c) * H + h) * W + w]
               : x[(int64_t(h) * W + w) * C + c];
  }
};

__global__ void __launch_bounds__(repro::THREADS)
conv_direct_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b, float* __restrict__ y, int C,
                   int H, int W, int M, int K, int stride, int pad, int OH,
                   int OW, int chw_in, int chw_out) {
  const int P = OH * OW, R = K * K * C;
  const int n = blockIdx.z;
  const InputGather gx{x + int64_t(n) * C * H * W, C, H, W, K, stride, pad,
                       OW, chw_in != 0};
  float* yn = y + int64_t(n) * M * P;
  if (chw_out) {
    // (M x R) @ (R x P): rows are channels, columns pixels
    auto la = [=](int m, int r) { return w[int64_t(r) * M + m]; };
    auto lb = [=](int r, int p) { return gx(p, r); };
    auto sc = [=](int m, int p, float v) { yn[int64_t(m) * P + p] = v + b[m]; };
    repro::tile_gemm(M, P, R, blockIdx.y * repro::BM, blockIdx.x * repro::BN,
                     la, lb, sc, /*a_k_fast=*/false, /*b_n_fast=*/chw_in != 0);
  } else {
    // (P x R) @ (R x M): rows are pixels, columns channels
    auto la = [=](int p, int r) { return gx(p, r); };
    auto lb = [=](int r, int m) { return w[int64_t(r) * M + m]; };
    auto sc = [=](int p, int m, float v) { yn[int64_t(p) * M + m] = v + b[m]; };
    repro::tile_gemm(P, M, R, blockIdx.y * repro::BM, blockIdx.x * repro::BN,
                     la, lb, sc, /*a_k_fast=*/chw_in == 0, /*b_n_fast=*/true);
  }
}

}  // namespace

extern "C" {

int repro_conv_direct(const void* x, const void* w, const void* b, void* y,
                      int nimg, int C, int H, int W, int M, int K,
                      int stride, int pad, int OH, int OW, int chw_in,
                      int chw_out, void* stream) {
  const int P = OH * OW;
  const int rows = chw_out ? M : P, cols = chw_out ? P : M;
  dim3 grid((cols + repro::BN - 1) / repro::BN,
            (rows + repro::BM - 1) / repro::BM, nimg);
  conv_direct_kernel<<<grid, repro::THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(y), C, H, W, M, K,
      stride, pad, OH, OW, chw_in, chw_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
