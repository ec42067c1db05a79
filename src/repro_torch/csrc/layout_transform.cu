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
// Design: one block of 32 x 8 threads moves a 32 x 32 tile through
// shared memory.  It reads the tile along S (the input's contiguous
// axis), so a warp loads 32 neighbouring elements, and writes it along R
// (the output's contiguous axis), so a warp stores 32 neighbouring
// elements.  The tile is padded by one column so that the column reads
// of the write phase fall in 32 different banks.  Ragged edges are
// masked in the kernel: the reference pads H to 8 and W to 128 and crops
// afterwards, this kernel needs neither.  blockIdx.z walks the batch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;
constexpr int ROWS = 8;  // threads in y; each moves TILE / ROWS rows

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

template <typename T>
cudaError_t launch(const void* x, void* y, int B, int R, int S,
                   cudaStream_t stream) {
  const dim3 grid((S + TILE - 1) / TILE, (R + TILE - 1) / TILE, B);
  transpose_kernel<T><<<grid, dim3(TILE, ROWS), 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), R, S);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// esize: bytes per element (1, 2, 4 or 8); the bits are copied as they
// are, so any dtype of that width transposes exactly.
int repro_transpose(const void* x, void* y, int B, int R, int S, int esize,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (esize) {
    case 1: return launch<uint8_t>(x, y, B, R, S, st);
    case 2: return launch<uint16_t>(x, y, B, R, S, st);
    case 4: return launch<uint32_t>(x, y, B, R, S, st);
    case 8: return launch<uint64_t>(x, y, B, R, S, st);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
