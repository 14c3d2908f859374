// resolve_tiled: out[p] = lit[fix(src)[p]], fix = src iterated to its
// fixed point, for maps with src[p] <= p (copy sources lie behind).
//
// Replaces tpu_snappy/ops/pallas/tiledres.py:resolve_tiled (the "fori"
// variant). The TPU kernel walks 4096-position tiles left to right; in
// each it runs pointer doubling to the tile-local fixed point with
// one-hot MXU gathers, then absorbs one byte gather from a plane that
// holds final bytes for every earlier tile. This kernel keeps that
// algorithm, because it is what bounds the work for any src with
// src[p] <= p (a per-lane chase of the period-1 chain would take 65535
// hops): one block per row keeps the tile's pointers in shared memory,
// doubles them with plain indexed loads (at most 13 rounds, stopping at
// the first round that moves nothing), and then reads each lane's byte
// from lit (an in-tile fixed point) or from the row's own output (an
// earlier tile, already final).
//
// Bound on this card: the serial walk. 16 tiles x up to 13 rounds x two
// barriers per row, with one block per row, so a small batch leaves most
// SMs idle; the traffic (lit, src, out: 768 KB per row) is small.
#include "common.cuh"

namespace {

constexpr int kTile = 4096;
constexpr int kThreads = 1024;
constexpr int kPer = kTile / kThreads;
constexpr int kMaxLocal = 13;  // bit_length(4096): rounds bound in-tile depth

__global__ void __launch_bounds__(kThreads)
resolve_tiled_kernel(const int32_t* __restrict__ lit,
                     const int32_t* __restrict__ src, int32_t* out) {
  __shared__ int32_t s[kTile];
  const size_t row = static_cast<size_t>(blockIdx.x) * snk::kBlock;
  const int32_t* L = lit + row;
  const int32_t* S = src + row;
  int32_t* O = out + row;
  for (int base = 0; base < snk::kBlock; base += kTile) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int q = threadIdx.x + j * kThreads;
      s[q] = S[base + q];
    }
    __syncthreads();
    // Local doubling: every lane ends at an in-tile fixed point or left of
    // the tile.
    for (int r = 0; r < kMaxLocal; ++r) {
      int nv[kPer];
      int moved = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int v = s[threadIdx.x + j * kThreads];
        const int d = v - base;
        nv[j] = (d >= 0 && d < kTile) ? s[d] : v;
        moved |= nv[j] != v;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[threadIdx.x + j * kThreads] = nv[j];
      if (!__syncthreads_or(moved)) break;
    }
    // Absorb: left-of-tile lanes read final bytes of earlier tiles, in-tile
    // lanes sit on a literal.
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int q = threadIdx.x + j * kThreads;
      const int v = s[q];
      O[base + q] = v >= base ? L[v] : O[v];
    }
    __syncthreads();
  }
}

}  // namespace

// lit, src, out: (batch, 65536) int32.
SNK_EXPORT int snk_resolve_tiled(const void* lit, const void* src, void* out,
                                 int batch, void* stream) {
  resolve_tiled_kernel<<<batch, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lit), static_cast<const int32_t*>(src),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
