// scatter_windowed: additive scatter of near-monotone destinations onto
// `cells` cells with a window per 1024-source tile, at 1 to 3 limbs; and
// scatter_block, the full-height additive scatter without a window.
//
// scatter_windowed replaces tpu_snappy/ops/pallas/scatter.py:
// scatter_windowed, and at one limb place.py:place_block, the encoder's
// placement of its main lane (wrows 32, cells = out_rows * 128), which
// computes the same rule. The TPU kernels build bf16 one-hots over a
// wrows x 128 window per 1024-source tile and multiply them on the MXU,
// one 8-bit limb at a time, because that chip has no vector scatter. What
// they compute, and what this kernel keeps exactly:
//   * per 1024-source tile, m = min active dest (active: 0 <= dest < cells),
//     base = min((m >> 10) << 3, cells/128 - wrows) in 128-cell rows;
//   * a write with (dest >> 7) - base >= wrows is dropped and counted;
//   * each of the LIMBS limbs (the top one unmasked, value >> 8 (LIMBS-1);
//     the others 8 bits) is summed per cell, and the limbs are joined by
//     shift-OR, (l0 << 16) | (l1 << 8) | l2 at three, not by addition; at
//     one limb the cell is the plain sum of its values.
// Since base <= m >> 7, an active dest is kept exactly when it lies below
// limit = (base + wrows) << 7, so a tile's kept writes are one range of
// cells.
//
// Bound on this card: bytes, reading (dest, value) once and writing the
// (batch, cells) output once. Two launches, no zero fill, 16 bytes of
// summary scratch a source tile:
//   1. the summary pass: per 1024-source tile, (base, lowest kept dest,
//      highest kept dest, drops), every entry written, with 16-byte loads;
//      window_summary_kernel (a block a tile) for fewer than
//      kWarpSummaryTiles tiles, window_summary_warp_kernel (a warp a tile,
//      eight loads in flight a lane, no barrier) from there on;
//   2. scatter_windowed_kernel<LIMBS>, grid (output tile, row), launched
//      as the summary pass's programmatic dependent, so that its blocks
//      start, and zero their planes, while the last summaries are being
//      computed (griddepcontrol.wait then holds them until all are
//      written): a block owns `tile` cells of its row as LIMBS int32
//      planes in shared memory, zeroes them there, reads its row's
//      summaries, lists the source tiles whose kept range meets its
//      cells, streams those tiles' (dest, value) pairs with 16-byte loads,
//      adds the limbs of the kept writes in its cells with shared-memory
//      atomics, joins the limbs and writes its cells once with 16-byte
//      stores (untouched cells 0). The block of output tile 0 also sums
//      its row's drops into ovf. The rows run last first, so that the
//      summaries and destinations the summary pass read last are still
//      in L2 when their blocks read them.
// Integer atomics make the sums independent of the order of the adds.
// Transport destinations are nearly monotone, so a source tile meets one
// or two output tiles and the sources are read about once (from L2 after
// the summary pass). Destinations spread over the whole row (random ones
// at wrows 512) make every source tile meet every output tile: still
// exact, but each block then reads the row's m sources, tiles x m x 8
// bytes of L2 reads a row. The wrapper (scatter.py:windowed_tile) picks
// the tile: 4096 cells (48 KB at three limbs, four blocks an SM; at one
// limb a larger tile fits but measured slower) while the grid fills the
// card, smaller for few rows. place_block's rows are 67584 cells, 16.5
// tiles of 4096: the last block of a row owns a partial tile.
// Its lanes' inactive positions carry a sentinel above the cells, and at
// placement "kernel" two lanes lie side by side in one row, so a source
// tile of the second lane meets output tiles far from those of its
// neighbours: the list holds every source tile whose kept range meets a
// block's cells, wherever it lies in the row.
//
// scatter_block replaces scatter.py:scatter_block, whose TPU kernel builds
// one-hots over the whole output height per source tile (MAC-bound in
// limbs x cells x sources). What it computes, and what this kernel keeps
// exactly: a destination outside [0, cells) drops, each limb of a value
// (the top one unmasked) sums per cell, and the limbs join by shift-OR.
//
// Bound on this card: bytes, i.e. writing the (batch, cells) output once.
// The encoder's call, (128, 2048) sources onto 67584 cells, writes 34.6 MB
// and reads 2 MB; almost all of its sources are dropped sentinels. So the
// output is written once and never zeroed or read in device memory: the
// grid is (tile, row), each block owns one tile of its row's output as
// one int32 accumulator per limb in shared memory, zeroes it there,
// streams all m (dest, value) pairs of its row with 16-byte loads (from
// L2 after the first tile's block has read them) and adds the limbs of
// those that fall in its tile with shared-memory atomics, then joins the
// limbs and writes the tile with 16-byte stores. One launch, no scratch,
// no zero pass. The cost is that every tile reads all m sources: tiles x
// m x 8 bytes of L2 reads a row, against cells x 4 bytes written. The
// wrapper (scatter.py:block_tile) picks the tile: large enough to fit in
// shared memory and to keep those reads at or below the row's output
// bytes, small enough that the grid fills the card.
#include "common.cuh"

#include <climits>

namespace {

constexpr int kTile = 1024;  // sources per window (the TPU kernel's grid step)
constexpr int kSummaryThreads = kTile / 4;  // four sources a thread
// Source tiles (batch x m / 1024) from which the summary pass runs one
// warp a tile: below, the block a tile's shorter chains are faster (8 and
// 16 rows of 64 tiles), from 32 rows on the warp's loads in flight.
constexpr int kWarpSummaryTiles = 2048;
constexpr int kWindowThreads = 2 * kTile / 4;  // two source tiles at a time
// scatter_windowed_kernel's static shared memory (the list of source tiles
// and its two counters), rounded up.
constexpr int kListBytes = 2 * kWindowThreads * 4 + 64;
constexpr int kScatterThreads = 256;
constexpr int kSrcUnroll = 4;  // scatter_block: 16-byte loads a thread

// The least active destination among a thread's K x 4.
template <int K>
__device__ __forceinline__ int active_min(const int4 (&d)[K], int cells) {
  int mn = INT_MAX;
#pragma unroll
  for (int u = 0; u < K; ++u) {
    const int e[4] = {d[u].x, d[u].y, d[u].z, d[u].w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (e[k] >= 0 && e[k] < cells) mn = min(mn, e[k]);
  }
  return mn;
}

// A warp's part of its tile's summary, from its lanes' K x 4 destinations
// and the tile's window limit: (0, lowest kept, highest kept, drops).
template <int K>
__device__ __forceinline__ int4 kept_range(const int4 (&d)[K], int cells,
                                           int limit) {
  int lo = INT_MAX, hi = -1, drops = 0;
#pragma unroll
  for (int u = 0; u < K; ++u) {
    const int e[4] = {d[u].x, d[u].y, d[u].z, d[u].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (e[k] < 0 || e[k] >= cells) continue;
      if (e[k] < limit) {
        lo = min(lo, e[k]);
        hi = max(hi, e[k]);
      } else {
        ++drops;
      }
    }
  }
  return make_int4(0, __reduce_min_sync(0xffffffffu, lo),
                   __reduce_max_sync(0xffffffffu, hi),
                   __reduce_add_sync(0xffffffffu, drops));
}

__device__ __forceinline__ int window_base(int mn, int cells, int wrows) {
  return min((mn >> 10) << 3, cells / 128 - wrows);
}

// Lets scatter_windowed_kernel, launched as this kernel's programmatic
// dependent, start its blocks (and zero their planes) while the last
// summaries are computed; it waits for them before reading any.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;");
}

// The summary pass for few source tiles. Grid (m / 1024, batch), 256
// threads: four sources a thread. summary gets (base, lowest kept dest,
// highest kept dest, drops) per source tile; a tile with no kept write
// gets lowest INT_MAX and highest -1.
__global__ void __launch_bounds__(kSummaryThreads)
window_summary_kernel(const int32_t* __restrict__ dest, int m, int cells,
                      int wrows, int4* __restrict__ summary) {
  launch_dependents();
  __shared__ int warp_min[kSummaryThreads / 32];
  __shared__ int4 warp_sum[kSummaryThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t tile = static_cast<size_t>(blockIdx.y) * (m / kTile)
                    + blockIdx.x;
  const int4 d[1] = {__ldg(reinterpret_cast<const int4*>(dest + tile * kTile)
                           + threadIdx.x)};
  int mn = __reduce_min_sync(0xffffffffu, active_min(d, cells));
  if (lane == 0) warp_min[warp] = mn;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kSummaryThreads / 32; ++w) mn = min(mn, warp_min[w]);
  const int base = window_base(mn, cells, wrows);
  const int4 r = kept_range(d, cells, (base + wrows) << 7);
  if (lane == 0) warp_sum[warp] = r;
  __syncthreads();
  if (threadIdx.x == 0) {
    int4 s = make_int4(base, INT_MAX, -1, 0);
#pragma unroll
    for (int w = 0; w < kSummaryThreads / 32; ++w) {
      s.y = min(s.y, warp_sum[w].y);
      s.z = max(s.z, warp_sum[w].z);
      s.w += warp_sum[w].w;
    }
    summary[tile] = s;
  }
}

// The summary pass for many source tiles (kWarpSummaryTiles or more):
// one warp a tile, 32 sources a lane in eight 16-byte loads, no barrier;
// 256 threads, eight tiles a block. The same summaries.
__global__ void __launch_bounds__(kSummaryThreads)
window_summary_warp_kernel(const int32_t* __restrict__ dest, int cells,
                           int wrows, int tiles,
                           int4* __restrict__ summary) {
  launch_dependents();
  constexpr int kLoads = kTile / 4 / 32;
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * (kSummaryThreads / 32) + (threadIdx.x >> 5);
  if (tile >= tiles) return;  // the whole warp
  const int4* d4 = reinterpret_cast<const int4*>(
      dest + static_cast<size_t>(tile) * kTile);
  int4 d[kLoads];
#pragma unroll
  for (int u = 0; u < kLoads; ++u) d[u] = __ldg(d4 + u * 32 + lane);
  const int mn = __reduce_min_sync(0xffffffffu, active_min(d, cells));
  const int base = window_base(mn, cells, wrows);
  const int4 r = kept_range(d, cells, (base + wrows) << 7);
  if (lane == 0) summary[tile] = make_int4(base, r.y, r.z, r.w);
}

// One limb of x: the top limb (j == 0) unmasked, the others 8 bits.
template <int LIMBS>
__device__ __forceinline__ int limb(int x, int j) {
  const int sh = 8 * (LIMBS - 1 - j);
  return j == 0 ? x >> sh : (x >> sh) & 0xFF;
}

// Shift-OR join of the sums so far and the next limb's sum.
__device__ __forceinline__ int join_limb(int hi, int lo) {
  return static_cast<int>(static_cast<unsigned>(hi) << 8
                          | static_cast<unsigned>(lo));
}

template <int LIMBS>
__device__ __forceinline__ void add_limbs(int32_t* acc, int tile, int c,
                                          int x) {
#pragma unroll
  for (int j = 0; j < LIMBS; ++j)
    atomicAdd(acc + j * tile + c, limb<LIMBS>(x, j));
}

// Grid (tiles, batch). acc: LIMBS planes of `tile` int32 cells (dynamic
// shared memory). tile and cells are multiples of 128 and m of 1024, so
// every row, plane and tile starts 16-byte aligned.
template <int LIMBS>
__global__ void __launch_bounds__(kScatterThreads)
scatter_block_kernel(const int32_t* __restrict__ dest,
                     const int32_t* __restrict__ vals, int m, int cells,
                     int tile, int32_t* __restrict__ out) {
  extern __shared__ int4 acc4[];
  int32_t* acc = reinterpret_cast<int32_t*>(acc4);
  const size_t row = blockIdx.y;
  const unsigned lo = blockIdx.x * tile;
  const unsigned n = min(static_cast<unsigned>(tile), cells - lo);
  for (int i = threadIdx.x; i < LIMBS * tile / 4; i += kScatterThreads)
    acc4[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  const int4* d4 = reinterpret_cast<const int4*>(dest + row * m);
  const int4* v4 = reinterpret_cast<const int4*>(vals + row * m);
  const int m4 = m / 4;
  for (int k0 = threadIdx.x; k0 < m4; k0 += kScatterThreads * kSrcUnroll) {
    int4 d[kSrcUnroll];
#pragma unroll
    for (int u = 0; u < kSrcUnroll; ++u) {
      const int k = k0 + u * kScatterThreads;
      d[u] = k < m4 ? __ldg(d4 + k) : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int u = 0; u < kSrcUnroll; ++u) {
      // Unsigned: a destination below 0 or below the tile wraps past n
      // (cells < 2^30, checked by the wrapper).
      const unsigned c0 = static_cast<unsigned>(d[u].x) - lo;
      const unsigned c1 = static_cast<unsigned>(d[u].y) - lo;
      const unsigned c2 = static_cast<unsigned>(d[u].z) - lo;
      const unsigned c3 = static_cast<unsigned>(d[u].w) - lo;
      if (min(min(c0, c1), min(c2, c3)) >= n) continue;
      const int4 v = __ldg(v4 + k0 + u * kScatterThreads);
      if (c0 < n) add_limbs<LIMBS>(acc, tile, c0, v.x);
      if (c1 < n) add_limbs<LIMBS>(acc, tile, c1, v.y);
      if (c2 < n) add_limbs<LIMBS>(acc, tile, c2, v.z);
      if (c3 < n) add_limbs<LIMBS>(acc, tile, c3, v.w);
    }
  }
  __syncthreads();
  int4* o4 = reinterpret_cast<int4*>(out + row * cells + lo);
  for (int i = threadIdx.x; i < static_cast<int>(n / 4);
       i += kScatterThreads) {
    int4 r = acc4[i];
#pragma unroll
    for (int j = 1; j < LIMBS; ++j) {
      const int4 a = acc4[j * tile / 4 + i];
      r = make_int4(join_limb(r.x, a.x), join_limb(r.y, a.y),
                    join_limb(r.z, a.z), join_limb(r.w, a.w));
    }
    o4[i] = r;
  }
}

template <int LIMBS>
int launch_scatter_block(const void* dest, const void* vals, void* out,
                         int m, int cells, int tile, int batch,
                         cudaStream_t s) {
  const int bytes = LIMBS * tile * 4;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        scatter_block_kernel<LIMBS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((cells + tile - 1) / tile, batch);
  scatter_block_kernel<LIMBS><<<grid, kScatterThreads, bytes, s>>>(
      static_cast<const int32_t*>(dest), static_cast<const int32_t*>(vals), m,
      cells, tile, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Grid (cells / tile rounded up, batch). acc: LIMBS planes of `tile` int32
// cells (dynamic shared memory). Each pass over the summaries lists up to
// kWindowThreads source tiles whose kept range meets this block's cells,
// with each one's effective end (the smaller of the window limit and the
// block's end); the list is then streamed two source tiles at a time, one
// per half of the block. Four blocks an SM at the wrapper's 4096-cell tile
// (52 KB of shared memory each at three limbs), so at most 32 registers a
// thread.
template <int LIMBS>
__global__ void __launch_bounds__(kWindowThreads, 4)
scatter_windowed_kernel(const int32_t* __restrict__ dest,
                        const int32_t* __restrict__ vals,
                        const int4* __restrict__ summary, int m, int cells,
                        int wrows, int tile, int32_t* __restrict__ out,
                        int32_t* __restrict__ ovf) {
  extern __shared__ int4 acc4[];
  __shared__ int list_tile[kWindowThreads];
  __shared__ int list_end[kWindowThreads];
  __shared__ int listed;
  __shared__ int row_drops;
  int32_t* acc = reinterpret_cast<int32_t*>(acc4);
  // The last rows first: their summaries and destinations are the ones
  // the summary pass read last, still in L2.
  const int row = gridDim.y - 1 - blockIdx.y;
  const int lo = blockIdx.x * tile;
  const int n = min(tile, cells - lo);
  const int end = lo + n;
  const bool counts = blockIdx.x == 0;
  for (int i = threadIdx.x; i < LIMBS * tile / 4; i += kWindowThreads)
    acc4[i] = make_int4(0, 0, 0, 0);
  if (threadIdx.x == 0) row_drops = 0;
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the summaries
  const int tiles = m / kTile;
  const int4* sum = summary + static_cast<size_t>(row) * tiles;
  const int4* d4 = reinterpret_cast<const int4*>(dest
                                                 + static_cast<size_t>(row) * m);
  const int4* v4 = reinterpret_cast<const int4*>(vals
                                                 + static_cast<size_t>(row) * m);
  const int half = threadIdx.x / (kTile / 4);
  const int k4 = threadIdx.x % (kTile / 4);
  int drops = 0;
  for (int t0 = 0; t0 < tiles; t0 += kWindowThreads) {
    if (threadIdx.x == 0) listed = 0;
    __syncthreads();  // listed reset; the zeroed planes before any add
    const int t = t0 + threadIdx.x;
    if (t < tiles) {
      const int4 s = __ldg(sum + t);
      if (counts) drops += s.w;
      if (s.y < end && s.z >= lo) {
        const int slot = atomicAdd(&listed, 1);
        list_tile[slot] = t;
        list_end[slot] = min(end, (s.x + wrows) << 7);
      }
    }
    __syncthreads();
    const int count = listed;
    // Each half streams every other listed tile, the next one's loads
    // issued before this one's adds.
    int i = half;
    int4 d = make_int4(-1, -1, -1, -1), v = d;
    if (i < count) {
      const size_t k = static_cast<size_t>(list_tile[i]) * (kTile / 4) + k4;
      d = __ldg(d4 + k);
      v = __ldg(v4 + k);
    }
    while (i < count) {
      const int next = i + 2;
      int4 dn = make_int4(-1, -1, -1, -1), vn = dn;
      if (next < count) {
        const size_t k = static_cast<size_t>(list_tile[next]) * (kTile / 4)
                       + k4;
        dn = __ldg(d4 + k);
        vn = __ldg(v4 + k);
      }
      // Kept and in this block's cells: lo <= dest < list_end, one
      // unsigned compare (a dest below lo wraps past the span).
      const unsigned ulo = static_cast<unsigned>(lo);
      const unsigned span = static_cast<unsigned>(list_end[i]) - ulo;
      const unsigned c0 = static_cast<unsigned>(d.x) - ulo;
      const unsigned c1 = static_cast<unsigned>(d.y) - ulo;
      const unsigned c2 = static_cast<unsigned>(d.z) - ulo;
      const unsigned c3 = static_cast<unsigned>(d.w) - ulo;
      if (c0 < span) add_limbs<LIMBS>(acc, tile, c0, v.x);
      if (c1 < span) add_limbs<LIMBS>(acc, tile, c1, v.y);
      if (c2 < span) add_limbs<LIMBS>(acc, tile, c2, v.z);
      if (c3 < span) add_limbs<LIMBS>(acc, tile, c3, v.w);
      d = dn;
      v = vn;
      i = next;
    }
    __syncthreads();  // the list is rewritten by the next pass
  }
  if (counts) {
    drops = __reduce_add_sync(0xffffffffu, drops);
    if ((threadIdx.x & 31) == 0 && drops) atomicAdd(&row_drops, drops);
  }
  __syncthreads();
  if (counts && threadIdx.x == 0) ovf[row] = row_drops;
  int4* o4 = reinterpret_cast<int4*>(out + static_cast<size_t>(row) * cells
                                     + lo);
  for (int i = threadIdx.x; i < n / 4; i += kWindowThreads) {
    int4 r = acc4[i];
#pragma unroll
    for (int j = 1; j < LIMBS; ++j) {
      const int4 a = acc4[j * tile / 4 + i];
      r = make_int4(join_limb(r.x, a.x), join_limb(r.y, a.y),
                    join_limb(r.z, a.z), join_limb(r.w, a.w));
    }
    o4[i] = r;
  }
}

template <int LIMBS>
int launch_scatter_windowed(const void* dest, const void* vals,
                            const void* summary, void* out, void* ovf, int m,
                            int cells, int wrows, int tile, int batch,
                            cudaStream_t s) {
  // The 48 KB a block gets without opting in counts the static list too.
  const int bytes = LIMBS * tile * 4;
  if (bytes + kListBytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        scatter_windowed_kernel<LIMBS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // A programmatic dependent of the summary pass (see launch_dependents).
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((cells + tile - 1) / tile, batch);
  cfg.blockDim = dim3(kWindowThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, scatter_windowed_kernel<LIMBS>,
      static_cast<const int32_t*>(dest), static_cast<const int32_t*>(vals),
      static_cast<const int4*>(summary), m, cells, wrows, tile,
      static_cast<int32_t*>(out), static_cast<int32_t*>(ovf));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// dest, vals: (batch, m) int32, m a multiple of 1024, 16-byte aligned;
// summary: (batch, m / 1024, 4) int32 scratch, every entry written; out:
// (batch, cells) int32, every cell written; ovf: (batch,) int32 drop
// counts, every entry written. cells is a multiple of 128, >= 128 * wrows
// and < 2^30; tile a multiple of 128 with limbs * tile * 4 bytes at most
// 227 KB less the list's 4 KB; 1 <= limbs <= 3.
SNK_EXPORT int snk_scatter_windowed(const void* dest, const void* vals,
                                    void* summary, void* out, void* ovf,
                                    int m, int cells, int wrows, int tile,
                                    int limbs, int batch, void* stream) {
  if (limbs < 1 || limbs > 3) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = batch * (m / kTile);
  if (tiles >= kWarpSummaryTiles) {
    constexpr int kPerBlock = kSummaryThreads / 32;
    window_summary_warp_kernel<<<(tiles + kPerBlock - 1) / kPerBlock,
                                 kSummaryThreads, 0, s>>>(
        static_cast<const int32_t*>(dest), cells, wrows, tiles,
        static_cast<int4*>(summary));
  } else {
    window_summary_kernel<<<dim3(m / kTile, batch), kSummaryThreads, 0, s>>>(
        static_cast<const int32_t*>(dest), m, cells, wrows,
        static_cast<int4*>(summary));
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (limbs) {
    case 1:
      return launch_scatter_windowed<1>(dest, vals, summary, out, ovf, m,
                                        cells, wrows, tile, batch, s);
    case 2:
      return launch_scatter_windowed<2>(dest, vals, summary, out, ovf, m,
                                        cells, wrows, tile, batch, s);
    default:
      return launch_scatter_windowed<3>(dest, vals, summary, out, ovf, m,
                                        cells, wrows, tile, batch, s);
  }
}

// dest, vals: (batch, m) int32, m a multiple of 1024; out: (batch, cells)
// int32, every cell written; cells and tile multiples of 128, cells <
// 2^30, limbs * tile * 4 bytes of shared memory at most 227 KB; 1 <= limbs
// <= 3.
SNK_EXPORT int snk_scatter_block(const void* dest, const void* vals,
                                 void* out, int m, int cells, int limbs,
                                 int tile, int batch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (limbs) {
    case 1:
      return launch_scatter_block<1>(dest, vals, out, m, cells, tile, batch,
                                     s);
    case 2:
      return launch_scatter_block<2>(dest, vals, out, m, cells, tile, batch,
                                     s);
    case 3:
      return launch_scatter_block<3>(dest, vals, out, m, cells, tile, batch,
                                     s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
