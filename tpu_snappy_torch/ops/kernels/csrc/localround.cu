// local_round: one in-tile pointer-doubling round over every tile at once,
// out[p] = src[src[p]] where src[p] lies in p's own tile, else src[p]; for
// maps with src[p] <= p (an in-tile source lies at or left of p, an
// out-of-tile one strictly left of the tile). Tiles of 128 << k
// positions, k = 0..9, as the TPU kernel takes.
//
// Replaces tpu_snappy/ops/pallas/localround.py:local_round, the parallel
// local rounds of the decoder's resolve="paratail". The TPU kernel builds a
// tile-diagonal one-hot (each target gathers only from its own tile's
// rows) and multiplies it on the MXU against bf16 8-bit limbs of the
// tile's state, because the TPU has no vector gather. Hopper has an
// indexed load, so none of that is carried over: one block per (row,
// 4096-position chunk) copies the chunk's 16 KB into shared memory, and
// each lane does one indexed read. Up to 4096-tiles an in-tile source lies
// in the lane's own chunk, so the read is of that snapshot; in a larger
// tile a source left of the chunk is read from src in device memory
// (through L2). A round reads src and writes out, never a lane already
// written, so it is synchronous, as on the TPU.
//
// Bound on this card: bytes. A round reads and writes 256 KB per row (one
// pass over src, one over out); the in-tile reads come from shared memory
// or, above 4096-tiles, partly from L2. Grid (16, batch): 2048 blocks at a
// 128-row wave.
#include "common.cuh"

namespace {

constexpr int kChunk = 4096;
constexpr int kThreads = 1024;
constexpr int kPer = kChunk / kThreads;

__global__ void __launch_bounds__(kThreads)
local_round_kernel(const int32_t* __restrict__ src, int32_t* __restrict__ out,
                   int tile_shift) {
  __shared__ int32_t s[kChunk];
  const int base = blockIdx.x * kChunk;
  const size_t row = static_cast<size_t>(blockIdx.y) * snk::kBlock;
  const int32_t* S = src + row;
  int32_t* O = out + row + base;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int q = threadIdx.x + j * kThreads;
    s[q] = S[base + q];
  }
  __syncthreads();
  const int tile = 1 << tile_shift;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int q = threadIdx.x + j * kThreads;
    const int v = s[q];
    const int tbase = (base + q) >> tile_shift << tile_shift;
    int w = v;
    if (static_cast<unsigned>(v - tbase) < static_cast<unsigned>(tile)) {
      const int d = v - base;
      w = static_cast<unsigned>(d) < kChunk ? s[d] : __ldg(S + v);
    }
    O[q] = w;
  }
}

}  // namespace

// src, out: (batch, 65536) int32; tile_shift: log2 of the tile, 7..16.
SNK_EXPORT int snk_local_round(const void* src, void* out, int batch,
                               int tile_shift, void* stream) {
  if (tile_shift < 7 || tile_shift > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(snk::kBlock / kChunk, batch);
  local_round_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), static_cast<int32_t*>(out),
      tile_shift);
  return static_cast<int>(cudaGetLastError());
}
