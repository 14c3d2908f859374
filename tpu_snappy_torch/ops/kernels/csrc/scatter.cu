// scatter_windowed: additive scatter of near-monotone destinations onto
// 65536 cells, with the window contract of the decode transport; and
// scatter_block, the full-height additive scatter without a window.
//
// scatter_windowed replaces tpu_snappy/ops/pallas/scatter.py:
// scatter_windowed. The TPU kernel builds bf16 one-hots over a wrows x 128
// window per 1024-source tile and multiplies them on the MXU, one 8-bit
// limb at a time, because that chip has no vector scatter. What it
// computes, and what this kernel keeps exactly:
//   * per 1024-source tile, m = min active dest (active: 0 <= dest < cells),
//     base = min((m >> 10) << 3, cells/128 - wrows) in 128-cell rows;
//   * a write with (dest >> 7) - base >= wrows is dropped and counted;
//   * each limb (value >> 16 unmasked, (value >> 8) & 255, value & 255) is
//     summed per cell, and the limbs are joined by shift-OR,
//     (l0 << 16) | (l1 << 8) | l2, not by addition.
// One block per source tile takes the block minimum, then every thread
// adds its limbs with integer atomics into a (batch, 3, cells) scratch the
// wrapper zeroes; a second pass joins the limbs. Integer atomics make the
// result independent of the order of the adds.
//
// Bound on this card: atomics and bytes. Transport destinations are
// nearly all distinct and monotone, so the atomics seldom collide; the
// scratch is 768 KB per row, read once by the join pass.
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
constexpr int kScatterThreads = 256;
constexpr int kSrcUnroll = 4;  // scatter_block: 16-byte loads a thread

__global__ void __launch_bounds__(kTile)
scatter_windowed_kernel(const int32_t* __restrict__ dest,
                        const int32_t* __restrict__ vals, int m, int cells,
                        int wrows, int32_t* __restrict__ acc,
                        int32_t* __restrict__ ovf) {
  __shared__ int warp_min[32];
  const int row = blockIdx.y;
  const size_t src = static_cast<size_t>(row) * m
                   + static_cast<size_t>(blockIdx.x) * kTile + threadIdx.x;
  const int d = dest[src];
  const bool active = d >= 0 && d < cells;
  const int wmin = __reduce_min_sync(0xffffffffu, active ? d : INT_MAX);
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = wmin;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int t = __reduce_min_sync(0xffffffffu, warp_min[threadIdx.x]);
    if (threadIdx.x == 0) warp_min[0] = t;
  }
  __syncthreads();
  if (!active) return;
  const int mn = warp_min[0];
  const int base = min((mn >> 10) << 3, cells / 128 - wrows);
  if ((d >> 7) - base >= wrows) {
    atomicAdd(ovf + row, 1);
    return;
  }
  const int x = vals[src];
  int32_t* a = acc + static_cast<size_t>(row) * 3 * cells;
  atomicAdd(a + d, x >> 16);
  atomicAdd(a + cells + d, (x >> 8) & 0xFF);
  atomicAdd(a + 2 * cells + d, x & 0xFF);
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

__global__ void join_limbs_kernel(const int32_t* __restrict__ acc,
                                  int32_t* __restrict__ out, int cells,
                                  int limbs, size_t total) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x
                   + threadIdx.x;
  if (idx >= total) return;
  const size_t row = idx / cells;
  const size_t c = idx % cells;
  const int32_t* a = acc + row * limbs * cells;
  uint32_t v = static_cast<uint32_t>(a[c]);
  for (int j = 1; j < limbs; ++j)
    v = v << 8 | static_cast<uint32_t>(a[j * cells + c]);
  out[idx] = static_cast<int32_t>(v);
}

int join(const void* acc, void* out, int cells, int limbs, int batch,
         cudaStream_t s) {
  const size_t total = static_cast<size_t>(batch) * cells;
  const int threads = 256;
  join_limbs_kernel<<<static_cast<unsigned>((total + threads - 1) / threads),
                      threads, 0, s>>>(static_cast<const int32_t*>(acc),
                                       static_cast<int32_t*>(out), cells,
                                       limbs, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dest, vals: (batch, m) int32, m a multiple of 1024; acc: zeroed
// (batch, 3, cells) int32 scratch; out: (batch, cells) int32; ovf: zeroed
// (batch,) int32 drop counts. cells is a multiple of 128, >= 128 * wrows.
SNK_EXPORT int snk_scatter_windowed(const void* dest, const void* vals,
                                    void* acc, void* out, void* ovf, int m,
                                    int cells, int wrows, int batch,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(m / kTile, batch);
  scatter_windowed_kernel<<<grid, kTile, 0, s>>>(
      static_cast<const int32_t*>(dest), static_cast<const int32_t*>(vals), m,
      cells, wrows, static_cast<int32_t*>(acc), static_cast<int32_t*>(ovf));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return join(acc, out, cells, 3, batch, s);
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
