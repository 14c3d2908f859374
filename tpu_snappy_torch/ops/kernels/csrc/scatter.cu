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
// limbs x cells x sources). Here every source adds its limbs with integer
// atomics: a destination outside [0, cells) drops, duplicates sum per limb,
// and the limbs join by shift-OR as above. With one limb (the encoder's
// 2048 overflow entries) the adds go straight into the zeroed output and
// no join runs. Bound on this card: bytes, i.e. zeroing and writing the
// output; the encoder's entries are almost all dropped sentinels.
#include "common.cuh"

#include <climits>

namespace {

constexpr int kTile = 1024;  // sources per window (the TPU kernel's grid step)
constexpr int kScatterThreads = 256;

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

__global__ void __launch_bounds__(kScatterThreads)
scatter_block_kernel(const int32_t* __restrict__ dest,
                     const int32_t* __restrict__ vals, int m, int cells,
                     int limbs, int32_t* __restrict__ acc) {
  const int row = blockIdx.y;
  const int i = blockIdx.x * kScatterThreads + threadIdx.x;
  if (i >= m) return;
  const size_t src = static_cast<size_t>(row) * m + i;
  const int d = dest[src];
  if (d < 0 || d >= cells) return;
  const int x = vals[src];
  int32_t* a = acc + static_cast<size_t>(row) * limbs * cells + d;
  for (int j = 0; j < limbs; ++j) {
    const int sh = 8 * (limbs - 1 - j);
    atomicAdd(a + static_cast<size_t>(j) * cells,
              j == 0 ? x >> sh : (x >> sh) & 0xFF);  // top limb unmasked
  }
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

// dest, vals: (batch, m) int32; acc: zeroed (batch, limbs, cells) int32
// scratch, or the zeroed output itself when limbs == 1; out: (batch,
// cells) int32; 1 <= limbs <= 3.
SNK_EXPORT int snk_scatter_block(const void* dest, const void* vals,
                                 void* acc, void* out, int m, int cells,
                                 int limbs, int batch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((m + kScatterThreads - 1) / kScatterThreads, batch);
  scatter_block_kernel<<<grid, kScatterThreads, 0, s>>>(
      static_cast<const int32_t*>(dest), static_cast<const int32_t*>(vals), m,
      cells, limbs, static_cast<int32_t*>(acc));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || limbs == 1) return static_cast<int>(err);
  return join(acc, out, cells, limbs, batch, s);
}
