// doubling_round: one pointer-doubling round s -> s o s with per-tile
// stability flags, for (batch, 65536) maps in [0, 65536) and (batch, 64)
// flags, one per 1024-position tile.
//
// Replaces tpu_snappy/ops/pallas/doubling.py:doubling_round, the round of
// the decoder's resolve="stable". A tile flagged stable (nonzero) is
// copied through and keeps flag 1; in any other tile every target reads
// out[p] = s[s[p]], and the tile's new flag is 1 iff no lane of it changed
// (its pointers all sit at fixed points, which never move again). The TPU
// kernel skips a stable tile's one-hot MXU gather; here the gather is one
// indexed load, so the skip saves that load.
//
// Design: one block per (tile, row), one thread per target. The table is
// the input row in device memory (256 KB a row, 32 MB a 128-row wave: the
// 50 MB L2 holds it), the output a separate buffer, so the round is
// synchronous. The tile's flag comes from __syncthreads_or. A pointer
// outside [0, 65536) reads 0, as the TPU's one-hot gives.
//
// Bound on this card: bytes (one read of s, one write of out per target;
// the gathered reads are random within the row and served by L2).
#include "common.cuh"

namespace {

constexpr int kTileSize = 1024;
constexpr int kTiles = snk::kBlock / kTileSize;

__global__ void __launch_bounds__(kTileSize)
doubling_kernel(const int32_t* __restrict__ s,
                const int32_t* __restrict__ stable, int32_t* __restrict__ out,
                int32_t* __restrict__ stable_out) {
  const int t = blockIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.y) * snk::kBlock;
  const int p = t * kTileSize + threadIdx.x;
  const int v = s[row + p];
  const size_t flag = static_cast<size_t>(blockIdx.y) * kTiles + t;
  if (stable[flag] != 0) {
    out[row + p] = v;
    if (threadIdx.x == 0) stable_out[flag] = 1;
    return;
  }
  const int w = (v >= 0 && v < snk::kBlock) ? __ldg(s + row + v) : 0;
  out[row + p] = w;
  const int moved = __syncthreads_or(w != v);
  if (threadIdx.x == 0) stable_out[flag] = moved ? 0 : 1;
}

}  // namespace

// s, out: (batch, 65536) int32; stable, stable_out: (batch, 64) int32.
SNK_EXPORT int snk_doubling_round(const void* s, const void* stable, void* out,
                                  void* stable_out, int batch, void* stream) {
  dim3 grid(kTiles, batch);
  doubling_kernel<<<grid, kTileSize, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(s), static_cast<const int32_t*>(stable),
      static_cast<int32_t*>(out), static_cast<int32_t*>(stable_out));
  return static_cast<int>(cudaGetLastError());
}
