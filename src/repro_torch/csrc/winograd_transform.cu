// The 2-D Winograd convolution's input and output transforms, f32:
//   V = B^T d B          for each alpha x alpha input tile d of each channel
//   y = A^T Q A + bias   for each alpha x alpha tile Q of the GEMM's output
// over F(m, k) for the registry's five 2-D pairs, (m, k) in {(2,3), (4,3),
// (6,3), (2,5), (4,5)}, so alpha = m + k - 1 in {4, 6, 8}.  Between them
// runs the batched GEMM Q[p] = U[p] @ V[p] over the alpha^2 points p.
//
// Replaces no Pallas kernel.  The reference computes both transforms as
// jnp einsums around its GEMM (src/repro/core/primitives.py _wino2d,
// src/repro/kernels/winograd_gemm/ops.py conv_winograd), and on the TPU
// XLA fuses them with the pad, the tile gather and the crop around them.
// In eager PyTorch nothing fuses them: each einsum lowers to a bmm behind
// permute copies.  These two kernels take the place of XLA's fusion.
//
// Bound on the H100: bytes.  The input transform reads x once and writes
// V (alpha^2 / m^2 values per output pixel and channel: 1.8x the input at
// F(6,3), 4x at F(2,3)); the output transform reads Q and writes y.  A
// tile of one channel costs 2 * alpha^3 FMAs (1024 at alpha = 8) against
// 4 * (alpha^2 + about m^2) bytes, about 5 operations a byte, a quarter
// of the f32 ridge of 67e12 / 3.35e12 = 20.
//
// Design.  A block takes one image's `rows` x `cols` tiles of `chans`
// channels; kernels/winograd_transform/kernel.py plans the three from the
// shapes and the shared-memory budget.  Every tile is one thread's.
// * Input: the block first stages the input rows its tiles cover in
//   shared memory, with loads that follow x's unit stride: a warp per row,
//   lanes along W, where W is it (CHW); consecutive threads on consecutive
//   channels where C is (HWC).  The loads are cp.async copies, which the
//   threads issue without waiting for each, so that a block's whole strip
//   is in flight at once: plain loads, each waited for before its store to
//   shared memory, took twice as long at VGG-16's batch-16 shapes.  Zero
//   padding and the tiles that overhang the plane are bounds checks on
//   these loads: no pad, no unfold.  Each thread then transforms its tile
//   in registers, separably (B^T d by columns, then (B^T d) B by rows),
//   and writes its alpha^2 values to V (alpha^2, C, N * T), images outer,
//   tiles row-major.  Consecutive threads hold consecutive tiles, so each
//   of a warp's writes is one run of consecutive addresses.
// * Output: each thread reads one tile of Q (alpha^2, M, N * T) the same
//   way, one run per point across the warp, transforms it, adds the bias
//   after the whole sum (as the plain version does) and stages its m x m
//   outputs in shared memory; the block then writes its rows, cropped to
//   the plane, through y's strides: whole rows along W (CHW), or runs of
//   channels (HWC).
// * A channel's slice of shared memory has an odd pitch, so the HWC
//   paths' channel-strided accesses fall on distinct banks.
// * The matrices arrive with the launch (the parameter space, read from
//   the constant bank): the wrapper takes them from
//   core/winograd_transforms.py, the plain version's source, so there is
//   one copy of their values and nothing to upload before a CUDA graph's
//   capture.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

// the most threads a block runs (the planner's ITEMS), and the most
// dynamic shared memory it takes (no opt-in attribute needed)
constexpr int kThreads = 256;
constexpr int kMaxSmem = 48 * 1024;
// blocks an SM keeps resident at least: caps a thread at 128 registers
// (alpha = 8 keeps a tile's 64 partial sums in them)
constexpr int kMinBlocks = 2;

template <int A>
struct InMat {
  float bt[A][A];  // B^T, row-major
};

template <int A, int M>
struct OutMat {
  float a[A][M];  // A, row-major
};

// One transform's geometry.  (n, c, h, w): the plane side's logical shape,
// x's (N, C, H, W) for the input transform, y's (N, M, OH, OW) for the
// output; (sn, sc, sh, sw) its strides in elements.  (nth, ntw): the tiles
// of one image; (rows, cols, chans): a block's share.
struct Geom {
  int n, c, h, w;
  int64_t sn, sc, sh, sw;
  int nth, ntw;
  int rows, cols, chans;
  int row_groups, col_groups;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// shared memory floats per channel: a row pitch of `pitch` floats over
// `rows_` rows, made odd
__host__ __device__ inline int chan_pitch(int rows_, int pitch) {
  return (rows_ * pitch) | 1;
}

// A 4-byte copy from global to shared memory that the thread does not wait
// for (cp.async): a block's loads of its strip are all in flight at once.
__device__ inline void copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ inline void wait_async() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// the block's (image, first tile row, first tile column) from blockIdx.x
struct Block {
  int img, th0, tw0, nr, nt, c0, nc;
  __device__ explicit Block(const Geom& g) {
    int b = blockIdx.x;
    const int cg = b % g.col_groups;
    b /= g.col_groups;
    const int rg = b % g.row_groups;
    img = b / g.row_groups;
    th0 = rg * g.rows;
    tw0 = cg * g.cols;
    nr = min(g.rows, g.nth - th0);
    nt = min(g.cols, g.ntw - tw0);
    c0 = blockIdx.y * g.chans;
    nc = min(g.chans, g.c - c0);
  }
};

template <int M, int K>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    wino_input_transform(const float* __restrict__ x, float* __restrict__ v,
                         Geom g, int pad, InMat<M + K - 1> mat) {
  constexpr int A = M + K - 1;
  extern __shared__ float strip[];
  const Block blk(g);
  // the strip: nc channels of sr rows of sc columns, pitches from the
  // block's full share so that every block lays it out alike
  const int sr = blk.nr * M + A - M, sc = blk.nt * M + A - M;
  const int rp = g.cols * M + A - M;
  const int cp = chan_pitch(g.rows * M + A - M, rp);
  const int y0 = blk.th0 * M - pad, x0 = blk.tw0 * M - pad;
  const float* xi = x + blk.img * g.sn + int64_t(blk.c0) * g.sc;
  if (g.sc == 1 && g.sw != 1) {  // HWC: lanes along C
    const int total = blk.nc * sr * sc;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int c = i % blk.nc, pos = i / blk.nc;
      const int r = pos / sc, col = pos - r * sc;
      const int yy = y0 + r, xx = x0 + col;
      float* dst = strip + c * cp + r * rp + col;
      if (yy >= 0 && yy < g.h && xx >= 0 && xx < g.w)
        copy_async(dst, xi + c + yy * g.sh + xx * g.sw);
      else
        *dst = 0.f;
    }
  } else {  // CHW and the rest: a warp per strip row, lanes along W
    const int lane = threadIdx.x % 32;
    for (int row = threadIdx.x / 32; row < blk.nc * sr;
         row += blockDim.x / 32) {
      const int c = row / sr, r = row - c * sr;
      const int yy = y0 + r;
      const bool in_h = yy >= 0 && yy < g.h;
      float* s = strip + c * cp + r * rp;
      for (int col = lane; col < sc; col += 32) {
        const int xx = x0 + col;
        if (in_h && xx >= 0 && xx < g.w)
          copy_async(s + col, xi + c * g.sc + yy * g.sh + xx * g.sw);
        else
          s[col] = 0.f;
      }
    }
  }
  wait_async();
  __syncthreads();

  const int per_chan = blk.nr * blk.nt;
  const int64_t T = int64_t(g.nth) * g.ntw;
  const int64_t NT = g.n * T;
  const int64_t pstride = g.c * NT;
  for (int it = threadIdx.x; it < blk.nc * per_chan; it += blockDim.x) {
    const int c = it / per_chan, t = it - c * per_chan;
    const int tr = t / blk.nt, tc = t - tr * blk.nt;
    const float* s = strip + c * cp + tr * M * rp + tc * M;
    float bd[A][A];  // B^T d, a column at a time
#pragma unroll
    for (int j = 0; j < A; ++j) {
      float col[A];
#pragma unroll
      for (int k = 0; k < A; ++k) col[k] = s[k * rp + j];
#pragma unroll
      for (int i = 0; i < A; ++i) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < A; ++k) acc = fmaf(mat.bt[i][k], col[k], acc);
        bd[i][j] = acc;
      }
    }
    float* out = v + (blk.c0 + c) * NT + blk.img * T +
                 int64_t(blk.th0 + tr) * g.ntw + blk.tw0 + tc;
#pragma unroll
    for (int i = 0; i < A; ++i) {
#pragma unroll
      for (int j = 0; j < A; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < A; ++k) acc = fmaf(bd[i][k], mat.bt[j][k], acc);
        out[(i * A + j) * pstride] = acc;
      }
    }
  }
}

template <int M, int K>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    wino_output_transform(const float* __restrict__ q,
                          const float* __restrict__ bias,
                          float* __restrict__ y, Geom g,
                          OutMat<M + K - 1, M> mat) {
  constexpr int A = M + K - 1;
  extern __shared__ float outs[];
  const Block blk(g);
  const int rp = g.cols * M;
  const int cp = chan_pitch(g.rows * M, rp);

  const int per_chan = blk.nr * blk.nt;
  const int64_t T = int64_t(g.nth) * g.ntw;
  const int64_t NT = g.n * T;
  const int64_t pstride = g.c * NT;
  for (int it = threadIdx.x; it < blk.nc * per_chan; it += blockDim.x) {
    const int c = it / per_chan, t = it - c * per_chan;
    const int tr = t / blk.nt, tc = t - tr * blk.nt;
    const float* src = q + (blk.c0 + c) * NT + blk.img * T +
                       int64_t(blk.th0 + tr) * g.ntw + blk.tw0 + tc;
    float aq[M][A];  // A^T Q, a column at a time
#pragma unroll
    for (int j = 0; j < A; ++j) {
      float col[A];
#pragma unroll
      for (int k = 0; k < A; ++k) col[k] = src[(k * A + j) * pstride];
#pragma unroll
      for (int i = 0; i < M; ++i) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < A; ++k) acc = fmaf(mat.a[k][i], col[k], acc);
        aq[i][j] = acc;
      }
    }
    const float bv = bias[blk.c0 + c];
    float* o = outs + c * cp + tr * M * rp + tc * M;
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < A; ++k) acc = fmaf(aq[i][k], mat.a[k][j], acc);
        o[i * rp + j] = acc + bv;
      }
    }
  }
  __syncthreads();

  // the block's outputs, cropped to the plane
  const int er = blk.nr * M, ec = blk.nt * M;
  const int oh0 = blk.th0 * M, ow0 = blk.tw0 * M;
  const int vr = min(er, g.h - oh0), vc = min(ec, g.w - ow0);
  float* yi = y + blk.img * g.sn + int64_t(blk.c0) * g.sc;
  if (g.sc == 1 && g.sw != 1) {  // HWC: lanes along C
    const int total = blk.nc * vr * vc;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int c = i % blk.nc, pos = i / blk.nc;
      const int r = pos / vc, col = pos - r * vc;
      yi[c + (oh0 + r) * g.sh + (ow0 + col) * g.sw] =
          outs[c * cp + r * rp + col];
    }
  } else {  // CHW and the rest: a warp per output row, lanes along W
    const int lane = threadIdx.x % 32;
    for (int row = threadIdx.x / 32; row < blk.nc * vr;
         row += blockDim.x / 32) {
      const int c = row / vr, r = row - c * vr;
      const float* s = outs + c * cp + r * rp;
      float* d = yi + c * g.sc + (oh0 + r) * g.sh + ow0 * g.sw;
      for (int col = lane; col < vc; col += 32) d[col * g.sw] = s[col];
    }
  }
}

// The tiles, the block decomposition and the launch shape; false where the
// kernel cannot run it.
bool make_geom(Geom& g, int m, int oh, int ow, int rows, int cols, int chans,
               int threads) {
  if (g.n < 1 || g.c < 1 || oh < 1 || ow < 1 || rows < 1 || cols < 1 ||
      chans < 1 || threads < 32 || threads > kThreads || threads % 32)
    return false;
  g.nth = cdiv(oh, m);
  g.ntw = cdiv(ow, m);
  g.rows = rows;
  g.cols = cols;
  g.chans = chans;
  g.row_groups = cdiv(g.nth, rows);
  g.col_groups = cdiv(g.ntw, cols);
  return int64_t(g.n) * g.row_groups * g.col_groups <= INT32_MAX &&
         cdiv(g.c, chans) <= 65535;
}

template <int M, int K>
int launch_input(const float* x, float* v, const float* bt, Geom g, int pad,
                 int rows, int cols, int chans, int threads,
                 cudaStream_t st) {
  constexpr int A = M + K - 1;
  const int oh = g.h + 2 * pad - K + 1, ow = g.w + 2 * pad - K + 1;
  if (pad < 0 || !make_geom(g, M, oh, ow, rows, cols, chans, threads))
    return int(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * size_t(chans) *
                      chan_pitch(rows * M + A - M, cols * M + A - M);
  if (smem > size_t(kMaxSmem)) return int(cudaErrorInvalidValue);
  InMat<A> mat;
  std::memcpy(mat.bt, bt, sizeof(mat.bt));
  const dim3 grid(g.n * g.row_groups * g.col_groups, cdiv(g.c, chans));
  wino_input_transform<M, K><<<grid, threads, smem, st>>>(x, v, g, pad, mat);
  return int(cudaGetLastError());
}

template <int M, int K>
int launch_output(const float* q, const float* bias, float* y,
                  const float* a, Geom g, int rows, int cols, int chans,
                  int threads, cudaStream_t st) {
  constexpr int A = M + K - 1;
  if (!make_geom(g, M, g.h, g.w, rows, cols, chans, threads))
    return int(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * size_t(chans) * chan_pitch(rows * M, cols * M);
  if (smem > size_t(kMaxSmem)) return int(cudaErrorInvalidValue);
  OutMat<A, M> mat;
  std::memcpy(mat.a, a, sizeof(mat.a));
  const dim3 grid(g.n * g.row_groups * g.col_groups, cdiv(g.c, chans));
  wino_output_transform<M, K><<<grid, threads, smem, st>>>(q, bias, y, g,
                                                          mat);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (N, C, H, W) through its strides (sn, sc, sh, sw) in elements, f32;
// v: a contiguous (alpha^2, C, N * T) f32, T = ceil(OH / m) * ceil(OW / m),
// OH = H + 2 pad - k + 1; bt: B^T, alpha x alpha f32 row-major, host memory.
// rows, cols, chans: a block's tile rows, tile columns and channels;
// threads: its threads (a multiple of 32, at most 256).  Refused with
// cudaErrorInvalidValue for another (m, k) or a launch the kernel cannot
// run.
int repro_wino_input_transform(const void* x, void* v, const void* bt, int m,
                               int k, int n, int c, int h, int w, int64_t sn,
                               int64_t sc, int64_t sh, int64_t sw, int pad,
                               int rows, int cols, int chans, int threads,
                               void* stream) {
  Geom g{n, c, h, w, sn, sc, sh, sw};
  const auto* xp = static_cast<const float*>(x);
  auto* vp = static_cast<float*>(v);
  const auto* b = static_cast<const float*>(bt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 3 && m == 2)
    return launch_input<2, 3>(xp, vp, b, g, pad, rows, cols, chans, threads,
                              st);
  if (k == 3 && m == 4)
    return launch_input<4, 3>(xp, vp, b, g, pad, rows, cols, chans, threads,
                              st);
  if (k == 3 && m == 6)
    return launch_input<6, 3>(xp, vp, b, g, pad, rows, cols, chans, threads,
                              st);
  if (k == 5 && m == 2)
    return launch_input<2, 5>(xp, vp, b, g, pad, rows, cols, chans, threads,
                              st);
  if (k == 5 && m == 4)
    return launch_input<4, 5>(xp, vp, b, g, pad, rows, cols, chans, threads,
                              st);
  return int(cudaErrorInvalidValue);
}

// q: a contiguous (alpha^2, M, N * T) f32; bias: (M,) f32; y: (N, M, OH, OW)
// through its strides (sn, sc, sh, sw) in elements; a: A, alpha x m f32
// row-major, host memory.  The rest as in repro_wino_input_transform.
int repro_wino_output_transform(const void* q, const void* bias, void* y,
                                const void* a, int m, int k, int n, int c,
                                int oh, int ow, int64_t sn, int64_t sc,
                                int64_t sh, int64_t sw, int rows, int cols,
                                int chans, int threads, void* stream) {
  Geom g{n, c, oh, ow, sn, sc, sh, sw};
  const auto* qp = static_cast<const float*>(q);
  const auto* bp = static_cast<const float*>(bias);
  auto* yp = static_cast<float*>(y);
  const auto* am = static_cast<const float*>(a);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 3 && m == 2)
    return launch_output<2, 3>(qp, bp, yp, am, g, rows, cols, chans, threads,
                               st);
  if (k == 3 && m == 4)
    return launch_output<4, 3>(qp, bp, yp, am, g, rows, cols, chans, threads,
                               st);
  if (k == 3 && m == 6)
    return launch_output<6, 3>(qp, bp, yp, am, g, rows, cols, chans, threads,
                               st);
  if (k == 5 && m == 2)
    return launch_output<2, 5>(qp, bp, yp, am, g, rows, cols, chans, threads,
                               st);
  if (k == 5 && m == 4)
    return launch_output<4, 5>(qp, bp, yp, am, g, rows, cols, chans, threads,
                               st);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
