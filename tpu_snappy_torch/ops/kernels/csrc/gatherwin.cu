// gather_window_anchored: for each 4096-target tile, anchor = min(max(idx
// over the tile) >> 12, 14) and the window is table positions
// [anchor * 4096, anchor * 4096 + 8192); y[p] = x[idx[p]] (16 bits) inside
// it, else idx[p]; inwin[p] = 1 inside, else 0.
//
// Replaces tpu_snappy/ops/pallas/gatherwin.py:gather_window_anchored, the
// opening rounds of the decoder's resolve="hybrid" with WINDOWED_OPENING.
// The TPU kernel feeds each tile's anchor through scalar prefetch, so its
// BlockSpecs bring two 4096-element blocks of the table (as int8 limbs)
// into VMEM, and gathers from them with a one-hot matmul. Here one block of
// 1024 threads takes one (row, tile): its 4096 indices sit in registers
// (four a thread), a block max-reduction gives the anchor, the 8192-entry
// window goes into shared memory as uint16 (16 KB), and each target reads
// it there: the window is the one kernel of the port where staging saves
// traffic, since Hopper's vector gather then never leaves the SM.
//
// Bound on this card: bytes. At the decoder's (128, 65536) wave, from
// itself: the map read once and y and inwin written (101 MB); each tile
// also reads its 32 KB window, twice its own share of the table, mostly
// from L2.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kTile = 4096;
constexpr int kWindow = 8192;
constexpr int kMaxAnchor = snk::kBlock / kTile - 2;
constexpr int kThreads = 1024;
constexpr int kPer = kTile / kThreads;

__global__ void __launch_bounds__(kThreads)
gather_window_anchored_kernel(const int32_t* __restrict__ x,
                              const int32_t* __restrict__ idx,
                              int32_t* __restrict__ y,
                              int32_t* __restrict__ inwin) {
  __shared__ uint16_t win[kWindow];
  __shared__ int warp_max[kThreads / 32];
  __shared__ int window_base;
  const size_t row = static_cast<size_t>(blockIdx.y) * snk::kBlock;
  const size_t off = row + static_cast<size_t>(blockIdx.x) * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  int j[kPer];
  int m = INT_MIN;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    j[q] = idx[off + threadIdx.x + q * kThreads];
    m = max(m, j[q]);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, d));
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = warp_max[lane];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      m = max(m, __shfl_xor_sync(0xffffffffu, m, d));
    if (lane == 0) window_base = min(max(m, 0) >> 12, kMaxAnchor) * kTile;
  }
  __syncthreads();

  const int base = window_base;
  const int32_t* X = x + row + base;
  for (int q = threadIdx.x; q < kWindow; q += kThreads) {
    win[q] = static_cast<uint16_t>(X[q]);
  }
  __syncthreads();

#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int d = j[q] - base;
    const bool in = d >= 0 && d < kWindow;
    const size_t o = off + threadIdx.x + q * kThreads;
    y[o] = in ? static_cast<int32_t>(win[d]) : j[q];
    inwin[o] = in ? 1 : 0;
  }
}

}  // namespace

// x, idx, y, inwin: (batch, 65536) int32.
SNK_EXPORT int snk_gather_window_anchored(const void* x, const void* idx,
                                          void* y, void* inwin, int batch,
                                          void* stream) {
  dim3 grid(snk::kBlock / kTile, batch);
  gather_window_anchored_kernel<<<grid, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(idx),
      static_cast<int32_t*>(y), static_cast<int32_t*>(inwin));
  return static_cast<int>(cudaGetLastError());
}
