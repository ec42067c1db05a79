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
// wide and coalesced, since the fast axis of the input is the slow axis
// of the output, and in keeping enough bytes in flight to cover HBM's
// latency.
//
// Design: three routes, chosen by the caller (plan() in
// kernels/layout_transform/kernel.py, a pure function of R, S, the
// element size and the batch) and passed to the C entry with, on the
// tile route, the tile and the grid.
//
// * The tile (route 0), for two long axes.  A tile is sized in bytes, not
//   elements: RB bytes along R (a run of an output row) by SB bytes along
//   S (a run of an input row), (RB/e) x (SB/e) elements.  Two are built
//   for each element size, 8 KB and 16 KB (BIG; f64 has the 8 KB one
//   only); the planner takes 8 KB, and 16 KB where the planes hold four
//   of them per SM (above 8 MiB of f32 planes).  Every
//   global access is one 16-byte chunk a thread where the row pitches
//   (S*e, R*e) and the base addresses allow it, else the widest word that
//   divides them, so an int8 transpose moves as many bytes per
//   instruction as an f32 one.  The 16-byte case is a kernel of its own
//   (WIDE): code for narrow words that it never runs cost a small plane
//   a fifth of its time.
//   - Fill: each thread copies N = 16/e chunks of the input tile,
//     neighbouring threads on neighbouring chunks of a row, with
//     cp.async straight into shared memory: N independent 16-byte loads
//     in flight per thread before its first store, the whole tile per
//     block.
//   - Drain: each thread reads an N x N block of elements (one chunk from
//     each of N consecutive rows), transposes it in registers (byte
//     permutes for 1- and 2-byte elements) and writes N chunks, one to
//     each of N output rows; neighbouring threads write neighbouring
//     chunks of an output row.
//   - Shared memory is unpadded and swizzled: chunk p of the tile lies at
//     p ^ ((p / (C*N)) % 8), C = SB/16 chunks a row.  Eight threads that
//     fill eight neighbouring chunks, and eight that drain the same chunk
//     column of eight neighbouring row blocks, then reach eight different
//     groups of four banks: both phases are free of bank conflicts at
//     16-byte width (the textbook tile's one-column pad rules 16-byte
//     shared accesses out).
//   - The grid is 1-D over (plane, tile), at most four blocks per SM, and
//     each block strides over its tiles two shared buffers deep: the next
//     tile's cp.async loads are in flight while this tile drains.  So the
//     batch, R and S have no grid limit; a 64-bit division on the way to
//     a block's first load costs hundreds of cycles, so the tile index is
//     split by multiplying (Divisor).
//   TMA (cp.async.bulk.tensor) would spare the load instructions but costs
//   a tensor-map encode on the host for every call, and cp.async already
//   keeps a whole tile in flight per block (PERF.md gives the route's
//   share of the byte bound at VGG-16's buckets, cold).
// * A short axis (routes 1 and 2, at most SHORT_MAX elements; conv1's
//   C = 3 or 4 against H*W = 65536 in the calibration sweep).  There a
//   tile holds a few live rows.  Instead each thread moves the whole
//   short axis of one position of the long axis, 256 positions a block.
//   Route 1 (R short, CHW -> HWC): the thread reads its R elements, one
//   from each input row, so that a warp's loads of a row are 32
//   neighbouring elements, and writes them as one run of R * esize bytes
//   in words of up to 16 bytes: a warp stores 32 * R * esize contiguous
//   bytes.  Route 2 (S short, HWC -> CHW) mirrors it: one load of the
//   run of S elements per position, and stores to each of the S output
//   rows that are coalesced across the warp.  A plane's blocks run on
//   grid x, the planes on (z, y), so any batch fits.
//
// Ragged edges are masked in the kernel: the reference pads H to 8 and W
// to 128 and crops afterwards, this kernel needs neither.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int SHORT_MAX = 16;  // the short routes' longest short axis
constexpr int SHORT_THREADS = 256;
constexpr int CHUNK = 16;      // bytes: the widest access, one smem chunk
// the most tiles of one launch: 2^31 - 1, past any tensor the card holds
// (2^31 tiles of 1 KB are 2 TB)
constexpr int64_t MAX_UNITS = 0x7fffffff;
constexpr int64_t MAX_GRID_Y = 65535;

__host__ __device__ constexpr int ilog2(int v) {
  return v <= 1 ? 0 : 1 + ilog2(v / 2);
}
// The tile route's tiles (kernel.py's SHAPES): bytes along R and along S
// of shape t.  A tile of E-byte elements takes shape log2(E) for 8 KB and
// the next for 16 KB (BIG), which f64 lacks; two buffers of 16 KB stay
// within the 48 KB of shared memory a block takes without opting in.
__host__ __device__ constexpr int tile_rb(int t) { return t < 2 ? 128 : 256; }
__host__ __device__ constexpr int tile_sb(int t) {
  return t == 0 ? 64 : (t == 3 ? 256 : 128);
}
__host__ __device__ constexpr int tile_shape(int e, bool big) {
  return ilog2(e) + (big ? 1 : 0);
}
__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// every group but the newest complete (this thread's copies)
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// `nbytes` (a multiple of `word`, at most 16) bytes of one input chunk
// into shared memory in words of `word` bytes: cp.async for 4 and 8, a
// plain load and store below (cp.async has no narrower copy).
__device__ __forceinline__ void fill_narrow(char* dst, const char* src,
                                            int nbytes, int word) {
  switch (word) {
    case 8:
#pragma unroll
      for (int i = 0; i < CHUNK; i += 8)
        if (i < nbytes) cp_async8(dst + i, src + i);
      break;
    case 4:
#pragma unroll
      for (int i = 0; i < CHUNK; i += 4)
        if (i < nbytes) cp_async4(dst + i, src + i);
      break;
    case 2:
#pragma unroll
      for (int i = 0; i < CHUNK; i += 2)
        if (i < nbytes)
          *reinterpret_cast<uint16_t*>(dst + i) =
              *reinterpret_cast<const uint16_t*>(src + i);
      break;
    default:
#pragma unroll
      for (int i = 0; i < CHUNK; ++i)
        if (i < nbytes) dst[i] = src[i];
  }
}

// The first `nbytes` (a multiple of `word`) bytes of a chunk held as four
// little-endian words, stored in words of `word` bytes.
__device__ __forceinline__ void store_chunk(char* dst, const uint32_t (&w)[4],
                                            int nbytes, int word) {
  switch (word) {
    case 16:
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      break;
    case 8:
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (8 * i < nbytes)
          *reinterpret_cast<uint2*>(dst + 8 * i) =
              make_uint2(w[2 * i], w[2 * i + 1]);
      break;
    case 4:
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * i < nbytes) *reinterpret_cast<uint32_t*>(dst + 4 * i) = w[i];
      break;
    case 2:
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (2 * i < nbytes)
          *reinterpret_cast<uint16_t*>(dst + 2 * i) =
              uint16_t(w[i / 2] >> (16 * (i % 2)));
      break;
    default:
#pragma unroll
      for (int i = 0; i < CHUNK; ++i)
        if (i < nbytes) dst[i] = char(w[i / 4] >> (8 * (i % 4)));
  }
}

// Column j of an N x N block of e-byte elements, N = 16/e, held as N rows
// of four words (row k's element j in word j*e/4): the chunk that holds
// rows 0..N-1 of column j.  j is a constant after unrolling, so the block
// stays in registers.
template <int E>
__device__ __forceinline__ void block_column(const uint32_t (&v)[CHUNK / E][4],
                                             int j, uint32_t (&o)[4]) {
  if constexpr (E == 8) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      o[2 * k] = v[k][2 * j];
      o[2 * k + 1] = v[k][2 * j + 1];
    }
  } else if constexpr (E == 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = v[k][j];
  } else if constexpr (E == 2) {
    // word m: rows 2m (low half) and 2m+1 (high half)
    const unsigned sel = (j & 1) ? 0x7632 : 0x5410;
#pragma unroll
    for (int m = 0; m < 4; ++m)
      o[m] = __byte_perm(v[2 * m][j >> 1], v[2 * m + 1][j >> 1], sel);
  } else {
    // word m: bytes of rows 4m .. 4m+3
    const unsigned b = j & 3, sel = b | ((4 + b) << 4);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const uint32_t lo =
          __byte_perm(v[4 * m][j >> 2], v[4 * m + 1][j >> 2], sel);
      const uint32_t hi =
          __byte_perm(v[4 * m + 2][j >> 2], v[4 * m + 3][j >> 2], sel);
      o[m] = __byte_perm(lo, hi, 0x5410);
    }
  }
}

// Division by a divisor fixed for a launch, of numerators below 2^31:
// n / d = umulhi(n, mul) >> shift (Granlund and Montgomery), a multiply
// where a 64-bit division costs hundreds of cycles on the path to a
// block's first load.
struct Divisor {
  uint32_t d, mul, shift;
};

Divisor make_divisor(uint32_t d) {
  Divisor v{d, 0, 0};
  if (d > 1) {
    uint32_t l = 0;  // ceil(log2 d)
    while ((uint64_t(1) << l) < d) ++l;
    v.mul = uint32_t(((uint64_t(1) << (31 + l)) + d - 1) / d);
    v.shift = l - 1;
  }
  return v;
}

__device__ __forceinline__ uint32_t divide(uint32_t n, Divisor v) {
  return v.d == 1 ? n : __umulhi(n, v.mul) >> v.shift;
}

// Where a tile lies: its plane and its first row and column.
struct TileAt {
  int64_t b, r0, s0;
};

// route 0: tiles of (RB/E) x (SB/E) elements, 8 KB or 16 KB (BIG), one
// N x N block per thread; WIDE: every load and store 16 bytes
// (lw = sw = 16), so that the common kernel carries no code for narrower
// words (which costs a small plane about a fifth of its time)
template <int E, bool BIG, bool WIDE>
__global__ void __launch_bounds__((tile_rb(tile_shape(E, BIG)) / CHUNK) *
                                  (tile_sb(tile_shape(E, BIG)) / CHUNK))
    tile_kernel(const char* __restrict__ x, char* __restrict__ y, int64_t R,
                int64_t S, Divisor tiles_s, Divisor tiles_plane,
                uint32_t total, int lw, int sw) {
  constexpr int RB = tile_rb(tile_shape(E, BIG));
  constexpr int SB = tile_sb(tile_shape(E, BIG));
  constexpr int N = CHUNK / E;        // elements a chunk
  constexpr int TR = RB / E;          // tile rows (along R)
  constexpr int TS = SB / E;          // tile columns (along S)
  constexpr int NBI = RB / CHUNK;     // row blocks (chunks of an output run)
  constexpr int C = SB / CHUNK;       // chunks of an input run
  constexpr int NT = NBI * C;         // threads
  constexpr int CHUNKS = TR * C;      // = NT * N
  constexpr int SHIFT = ilog2(C * N);
  static_assert(C * N >= 8 && NBI >= 8, "the swizzle needs 8 chunks");
  extern __shared__ uint4 smem[];     // two buffers of CHUNKS chunks

  const int64_t pitch_in = S * E, pitch_out = R * E;
  auto swz = [](int p) { return p ^ ((p >> SHIFT) & 7); };

  auto locate = [&](uint32_t t) {
    const uint32_t b = divide(t, tiles_plane);
    const uint32_t rem = t - b * tiles_plane.d;
    const uint32_t tr = divide(rem, tiles_s);
    return TileAt{int64_t(b), int64_t(tr) * TR,
                  int64_t(rem - tr * tiles_s.d) * TS};
  };

  auto fill = [&](const TileAt& at, uint4* buf) {
    const char* src = x + ((at.b * R + at.r0) * S + at.s0) * E;
    const int64_t rows = R - at.r0;
    const int sbytes = int(lmin((S - at.s0) * E, SB));
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int p = threadIdx.x + i * NT;
      const int r = p / C, cb = (p % C) * CHUNK;
      if (r < rows && cb < sbytes) {
        const char* g = src + r * pitch_in + cb;
        char* d = reinterpret_cast<char*>(buf + swz(p));
        if (WIDE || lw == CHUNK)
          cp_async16(d, g);
        else
          fill_narrow(d, g, int(lmin(CHUNK, sbytes - cb)), lw);
      }
    }
  };

  auto drain = [&](const TileAt& at, const uint4* buf) {
    const int bi = threadIdx.x % NBI, c = threadIdx.x / NBI;
    const int64_t rfirst = at.r0 + bi * N, sfirst = at.s0 + c * N;
    if (rfirst >= R || sfirst >= S) return;
    const int rbytes = int(lmin((R - rfirst) * E, CHUNK));
    const int scount = int(lmin(S - sfirst, N));
    uint32_t v[N][4];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const uint4 q = buf[swz((bi * N + k) * C + c)];
      v[k][0] = q.x;
      v[k][1] = q.y;
      v[k][2] = q.z;
      v[k][3] = q.w;
    }
    char* dst = y + ((at.b * S + sfirst) * R + rfirst) * E;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j < scount) {
        uint32_t o[4];
        block_column<E>(v, j, o);
        store_chunk(dst + j * pitch_out, o, rbytes, WIDE ? CHUNK : sw);
      }
    }
  };

  uint32_t t = blockIdx.x;
  if (t >= total) return;
  uint4* cur = smem;
  uint4* nxt = smem + CHUNKS;
  TileAt at = locate(t);
  fill(at, cur);
  cp_async_commit();
  for (;;) {
    // the next tile's loads in flight while this one drains
    const uint32_t next = t + gridDim.x;
    const bool more = next < total;
    TileAt nat{};
    if (more) {
      nat = locate(next);
      fill(nat, nxt);
    }
    cp_async_commit();
    cp_async_wait_all_but_newest();
    __syncthreads();
    drain(at, cur);
    if (!more) break;
    __syncthreads();  // the buffer is refilled two tiles on
    t = next;
    at = nat;
    uint4* done = cur;
    cur = nxt;
    nxt = done;
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

// route 1, R short: Y[s, 0:R] = X[0:R, s], one position s per thread,
// plane z * gridDim.y + y.  I: the index type of the long axis, 32 bits
// wherever it fits (64-bit positions cost the short routes a tenth of a
// small plane's time)
template <typename T, typename I>
__global__ void __launch_bounds__(SHORT_THREADS)
    short_rows_kernel(const T* __restrict__ x, T* __restrict__ y, int R,
                      I S, int64_t B, int word) {
  const I s = I(blockIdx.x) * SHORT_THREADS + I(threadIdx.x);
  const int64_t b = int64_t(blockIdx.z) * gridDim.y + blockIdx.y;
  if (s >= S || b >= B) return;
  const int64_t plane = int64_t(R) * S;
  const T* xb = x + b * plane + s;
  Run<T> run;
#pragma unroll
  for (int r = 0; r < SHORT_MAX; ++r)
    if (r < R) run.e[r] = xb[int64_t(r) * S];
  run.store(reinterpret_cast<char*>(y + b * plane + int64_t(s) * R),
            R * int(sizeof(T)), word);
}

// route 2, S short: Y[0:S, r] = X[r, 0:S], one position r per thread
template <typename T, typename I>
__global__ void __launch_bounds__(SHORT_THREADS)
    short_cols_kernel(const T* __restrict__ x, T* __restrict__ y, I R,
                      int S, int64_t B, int word) {
  const I r = I(blockIdx.x) * SHORT_THREADS + I(threadIdx.x);
  const int64_t b = int64_t(blockIdx.z) * gridDim.y + blockIdx.y;
  if (r >= R || b >= B) return;
  const int64_t plane = int64_t(R) * S;
  Run<T> run;
  run.load(reinterpret_cast<const char*>(x + b * plane + int64_t(r) * S),
           S * int(sizeof(T)), word);
  T* yb = y + b * plane + r;
#pragma unroll
  for (int s = 0; s < SHORT_MAX; ++s)
    if (s < S) yb[int64_t(s) * R] = run.e[s];
}

// The widest word (16 bytes at most) that divides a run of `bytes` and
// the base address: every run then starts on a word boundary.
int word_bytes(const void* base, int64_t bytes) {
  int w = 16;
  while (w > 1 && (bytes % w || reinterpret_cast<uintptr_t>(base) % w))
    w /= 2;
  return w;
}

template <int E, bool BIG>
cudaError_t launch_tile(const void* x, void* y, int64_t B, int64_t R,
                        int64_t S, int grid, cudaStream_t stream) {
  constexpr int RB = tile_rb(tile_shape(E, BIG));
  constexpr int SB = tile_sb(tile_shape(E, BIG));
  constexpr int TR = RB / E, TS = SB / E;
  constexpr int NT = (RB / CHUNK) * (SB / CHUNK);
  constexpr int SMEM = 2 * TR * SB;
  const int lw = word_bytes(x, S * E), sw = word_bytes(y, R * E);
  const bool wide = lw == CHUNK && sw == CHUNK;
  const auto kernel =
      wide ? tile_kernel<E, BIG, true> : tile_kernel<E, BIG, false>;
  const int64_t tiles_s = (S + TS - 1) / TS;
  const int64_t tiles_plane = (R + TR - 1) / TR * tiles_s;
  if (tiles_plane * B > MAX_UNITS) return cudaErrorInvalidValue;
  kernel<<<grid, NT, SMEM, stream>>>(
      static_cast<const char*>(x), static_cast<char*>(y), R, S,
      make_divisor(uint32_t(tiles_s)), make_divisor(uint32_t(tiles_plane)),
      uint32_t(tiles_plane * B), lw, sw);
  return cudaGetLastError();
}

// a short route: a plane's blocks of positions on grid x, the planes on
// (z, y)
template <typename T, typename I>
cudaError_t launch_short(const T* x, T* y, int64_t B, int64_t R, int64_t S,
                         int route, int word, cudaStream_t stream) {
  const int64_t gy = B < MAX_GRID_Y ? B : MAX_GRID_Y;
  const dim3 g{
      unsigned(((route == 1 ? S : R) + SHORT_THREADS - 1) / SHORT_THREADS),
      unsigned(gy), unsigned((B + gy - 1) / gy)};
  if (route == 1)
    short_rows_kernel<T, I>
        <<<g, SHORT_THREADS, 0, stream>>>(x, y, int(R), I(S), B, word);
  else
    short_cols_kernel<T, I>
        <<<g, SHORT_THREADS, 0, stream>>>(x, y, I(R), int(S), B, word);
  return cudaGetLastError();
}

template <int E>
cudaError_t launch(const void* x, void* y, int64_t B, int64_t R, int64_t S,
                   int tile, int grid, int route, cudaStream_t stream) {
  using T = typename std::conditional<
      E == 1, uint8_t,
      typename std::conditional<
          E == 2, uint16_t,
          typename std::conditional<E == 4, uint32_t,
                                    uint64_t>::type>::type>::type;
  if (route == 0) {
    if (tile == 0) return launch_tile<E, false>(x, y, B, R, S, grid, stream);
    if constexpr (E < 8)  // f64 has no 16 KB tile
      return launch_tile<E, true>(x, y, B, R, S, grid, stream);
    return cudaErrorInvalidValue;
  }
  const T* xs = static_cast<const T*>(x);
  T* ys = static_cast<T*>(y);
  const int word = route == 1 ? word_bytes(y, R * E) : word_bytes(x, S * E);
  if ((route == 1 ? S : R) <= INT32_MAX - SHORT_THREADS)
    return launch_short<T, int32_t>(xs, ys, B, R, S, route, word, stream);
  return launch_short<T, int64_t>(xs, ys, B, R, S, route, word, stream);
}

}  // namespace

extern "C" {

// esize: bytes per element (1, 2, 4 or 8); the bits are copied as they
// are, so any dtype of that width transposes exactly.  route: 0 the tile,
// 1 R short, 2 S short (at most 16 elements).  tile and grid, read on the
// tile route only: the tile (0: 8 KB, 1: 16 KB, which f64 lacks) and the
// blocks, each striding over tiles (a short route launches a block per
// 256 positions of a plane, the planes on grid (z, y)).  Refused with
// cudaErrorInvalidValue where the kernel cannot run it.
int repro_transpose(const void* x, void* y, int64_t B, int64_t R, int64_t S,
                    int esize, int tile, int grid, int route, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route < 0 || route > 2 || (route == 1 && R > SHORT_MAX) ||
      (route == 2 && S > SHORT_MAX) || B < 1 || R < 1 || S < 1 ||
      (route == 0 && (grid < 1 || tile < 0 || tile > 1)))
    return int(cudaErrorInvalidValue);
  switch (esize) {
    case 1: return launch<1>(x, y, B, R, S, tile, grid, route, st);
    case 2: return launch<2>(x, y, B, R, S, tile, grid, route, st);
    case 4: return launch<4>(x, y, B, R, S, tile, grid, route, st);
    case 8: return launch<8>(x, y, B, R, S, tile, grid, route, st);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
