// Batched 2-D transpose Y[b] = X[b]^T, X (B, R, S) -> Y (B, S, R), for
// elements of 1, 2, 4 or 8 bytes: the one kernel behind the four layout
// transforms of repro_torch.kernels.layout_transform.
//
// Replaces: src/repro/kernels/layout_transform/kernel.py
// chw_to_hwc_pallas, hwc_to_chw_pallas, chw_to_hwc8_pallas and
// hwc8_to_chw_pallas.  In row-major memory (H, W, C/8, 8) holds the same
// bytes as (H, W, C), so each of the four is this transpose plus views:
//   CHW  -> HWC   R = C,     S = H*W
//   HWC  -> CHW   R = H*W,   S = C
//   CHW  -> HWC8  as CHW -> HWC, then viewed (H, W, C/8, 8)
//   HWC8 -> CHW   viewed (H, W, C), then as HWC -> CHW
//
// Bound on the H100: a transpose does no arithmetic and moves each
// element once in and once out, 2 * B*R*S * elem bytes over 3.35e12 B/s:
// bound by bytes.  The cost is in making both the reads and the writes
// coalesced, since the fast axis of the input is the slow axis of the
// output.
//
// Design: two routes, chosen by the caller (route() in
// kernels/layout_transform/kernel.py, a pure function of R, S and the
// element size) and passed to the C entry.
//
// * The tile (route 0), for two long axes: one block of 32 x 8 threads
//   moves a 32 x 32 tile through shared memory.  It reads the tile along
//   S (the input's contiguous axis), so a warp loads 32 neighbouring
//   elements, and writes it along R (the output's contiguous axis), so a
//   warp stores 32 neighbouring elements.  The tile is padded by one
//   column so that the column reads of the write phase fall in 32
//   different banks.
// * A short axis (routes 1 and 2, at most SHORT_MAX elements; conv1's
//   C = 3 or 4 against H*W = 65536 in the calibration sweep).  There a
//   32 x 32 tile holds a few live rows: 1/8 of its threads work, and each
//   of its stores moves 16 bytes.  Instead each thread moves the whole
//   short axis of one position of the long axis, 256 positions a block.
//   Route 1 (R short, CHW -> HWC): the thread reads its R elements, one
//   from each input row, so that a warp's loads of a row are 32
//   neighbouring elements, and writes them as one run of R * esize bytes
//   in words of up to 16 bytes: a warp stores 32 * R * esize contiguous
//   bytes.  Route 2 (S short, HWC -> CHW) mirrors it: one load of the
//   run of S elements per position, and stores to each of the S output
//   rows that are coalesced across the warp.
//
// Ragged edges are masked in the kernel: the reference pads H to 8 and W
// to 128 and crops afterwards, this kernel needs neither.  The batch
// rides on the grid.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int TILE = 32;
constexpr int ROWS = 8;  // threads in y; each moves TILE / ROWS rows
constexpr int SHORT_MAX = 16;  // the short routes' longest short axis
constexpr int SHORT_THREADS = 256;

template <typename T>
__global__ void transpose_kernel(const T* __restrict__ x, T* __restrict__ y,
                                 int R, int S) {
  __shared__ T tile[TILE][TILE + 1];
  const int64_t plane = int64_t(R) * S;
  const T* xb = x + blockIdx.z * plane;
  T* yb = y + blockIdx.z * plane;
  const int s0 = blockIdx.x * TILE;
  const int r0 = blockIdx.y * TILE;
  // read X[r0 + i, s0 + tx] along S
  const int s = s0 + threadIdx.x;
  for (int i = threadIdx.y; i < TILE; i += ROWS) {
    const int r = r0 + i;
    if (r < R && s < S) tile[i][threadIdx.x] = xb[int64_t(r) * S + s];
  }
  __syncthreads();
  // write Y[s0 + i, r0 + tx] along R
  const int r = r0 + threadIdx.x;
  for (int i = threadIdx.y; i < TILE; i += ROWS) {
    const int so = s0 + i;
    if (so < S && r < R) yb[int64_t(so) * R + r] = tile[threadIdx.x][i];
  }
}

// A run of up to SHORT_MAX elements in registers, moved to or from memory
// in words of W bytes (every index is a constant after unrolling, so the
// arrays stay in registers).
template <typename T>
struct Run {
  T e[SHORT_MAX];

  template <typename W>
  __device__ __forceinline__ void store(char* dst, int nbytes) const {
    constexpr int NW = sizeof(e) / sizeof(W);
    W w[NW];
    memcpy(w, e, sizeof(e));
#pragma unroll
    for (int i = 0; i < NW; ++i)
      if (i * int(sizeof(W)) < nbytes) reinterpret_cast<W*>(dst)[i] = w[i];
  }
  template <typename W>
  __device__ __forceinline__ void load(const char* src, int nbytes) {
    constexpr int NW = sizeof(e) / sizeof(W);
    W w[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i)
      w[i] = i * int(sizeof(W)) < nbytes
                 ? reinterpret_cast<const W*>(src)[i]
                 : W{};
    memcpy(e, w, sizeof(e));
  }
  // word: bytes per access, a power of two dividing nbytes and the
  // run's address
  __device__ __forceinline__ void store(char* dst, int nbytes,
                                        int word) const {
    switch (word) {
      case 16: store<uint4>(dst, nbytes); break;
      case 8: store<uint2>(dst, nbytes); break;
      case 4: store<uint32_t>(dst, nbytes); break;
      case 2: store<uint16_t>(dst, nbytes); break;
      default: store<uint8_t>(dst, nbytes);
    }
  }
  __device__ __forceinline__ void load(const char* src, int nbytes, int word) {
    switch (word) {
      case 16: load<uint4>(src, nbytes); break;
      case 8: load<uint2>(src, nbytes); break;
      case 4: load<uint32_t>(src, nbytes); break;
      case 2: load<uint16_t>(src, nbytes); break;
      default: load<uint8_t>(src, nbytes);
    }
  }
};

// route 1, R short: Y[s, 0:R] = X[0:R, s], one position s per thread
template <typename T>
__global__ void __launch_bounds__(SHORT_THREADS)
    short_rows_kernel(const T* __restrict__ x, T* __restrict__ y, int R,
                      int S, int word) {
  const int s = blockIdx.x * SHORT_THREADS + threadIdx.x;
  if (s >= S) return;
  const int64_t plane = int64_t(R) * S;
  const T* xb = x + blockIdx.y * plane + s;
  Run<T> run;
#pragma unroll
  for (int r = 0; r < SHORT_MAX; ++r)
    if (r < R) run.e[r] = xb[int64_t(r) * S];
  run.store(reinterpret_cast<char*>(y + blockIdx.y * plane + int64_t(s) * R),
            R * int(sizeof(T)), word);
}

// route 2, S short: Y[0:S, r] = X[r, 0:S], one position r per thread
template <typename T>
__global__ void __launch_bounds__(SHORT_THREADS)
    short_cols_kernel(const T* __restrict__ x, T* __restrict__ y, int R,
                      int S, int word) {
  const int r = blockIdx.x * SHORT_THREADS + threadIdx.x;
  if (r >= R) return;
  const int64_t plane = int64_t(R) * S;
  Run<T> run;
  run.load(reinterpret_cast<const char*>(x + blockIdx.y * plane +
                                         int64_t(r) * S),
           S * int(sizeof(T)), word);
  T* yb = y + blockIdx.y * plane + r;
#pragma unroll
  for (int s = 0; s < SHORT_MAX; ++s)
    if (s < S) yb[int64_t(s) * R] = run.e[s];
}

// The widest word (16 bytes at most) that divides a run of `bytes` and
// the base address: every run then starts on a word boundary.
int word_bytes(const void* base, int bytes) {
  int w = 16;
  while (w > 1 && (bytes % w || reinterpret_cast<uintptr_t>(base) % w))
    w /= 2;
  return w;
}

template <typename T>
cudaError_t launch(const void* x, void* y, int B, int R, int S, int route,
                   cudaStream_t stream) {
  const T* xs = static_cast<const T*>(x);
  T* ys = static_cast<T*>(y);
  if (route == 0) {
    const dim3 grid((S + TILE - 1) / TILE, (R + TILE - 1) / TILE, B);
    transpose_kernel<T><<<grid, dim3(TILE, ROWS), 0, stream>>>(xs, ys, R, S);
  } else if (route == 1) {
    const dim3 grid((S + SHORT_THREADS - 1) / SHORT_THREADS, B);
    short_rows_kernel<T><<<grid, SHORT_THREADS, 0, stream>>>(
        xs, ys, R, S, word_bytes(y, R * int(sizeof(T))));
  } else {
    const dim3 grid((R + SHORT_THREADS - 1) / SHORT_THREADS, B);
    short_cols_kernel<T><<<grid, SHORT_THREADS, 0, stream>>>(
        xs, ys, R, S, word_bytes(x, S * int(sizeof(T))));
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// esize: bytes per element (1, 2, 4 or 8); the bits are copied as they
// are, so any dtype of that width transposes exactly.  route: 0 the tile,
// 1 R short, 2 S short (at most 16 elements); refused with
// cudaErrorInvalidValue where the kernel cannot run it.
int repro_transpose(const void* x, void* y, int B, int R, int S, int esize,
                    int route, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route < 0 || route > 2 || (route == 1 && R > SHORT_MAX) ||
      (route == 2 && S > SHORT_MAX) || B > 65535 ||
      (route == 0 && (R + TILE - 1) / TILE > 65535))
    return int(cudaErrorInvalidValue);
  switch (esize) {
    case 1: return launch<uint8_t>(x, y, B, R, S, route, st);
    case 2: return launch<uint16_t>(x, y, B, R, S, route, st);
    case 4: return launch<uint32_t>(x, y, B, R, S, route, st);
    case 8: return launch<uint64_t>(x, y, B, R, S, route, st);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
