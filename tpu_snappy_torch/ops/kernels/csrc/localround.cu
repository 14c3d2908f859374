// local_round: one in-tile pointer-doubling round over every tile at once,
// out[p] = src[src[p]] where src[p] lies in p's own 4096-position tile,
// else src[p]; for maps with src[p] <= p (an in-tile source lies at or
// left of p, an out-of-tile one strictly left of the tile).
//
// Replaces tpu_snappy/ops/pallas/localround.py:local_round, the parallel
// local rounds of the decoder's resolve="paratail". The TPU kernel builds a
// tile-diagonal one-hot (each target gathers only from its own tile's
// rows) and multiplies it on the MXU against bf16 8-bit limbs of the
// tile's state, because the TPU has no vector gather. Hopper has an
// indexed load, so none of that is carried over: one block per (row,
// tile) copies the tile's 16 KB into shared memory, and each lane does one
// indexed read of that snapshot. Reads see only the snapshot, never a
// lane already written, so the round is synchronous, as on the TPU.
//
// Bound on this card: bytes. A round reads and writes 256 KB per row (one
// pass over src, one over out); the in-tile reads come from shared
// memory. Grid (16, batch): 2048 blocks at a 128-row wave.
#include "common.cuh"

namespace {

constexpr int kTile = 4096;
constexpr int kThreads = 1024;
constexpr int kPer = kTile / kThreads;

__global__ void __launch_bounds__(kThreads)
local_round_kernel(const int32_t* __restrict__ src, int32_t* __restrict__ out) {
  __shared__ int32_t s[kTile];
  const int base = blockIdx.x * kTile;
  const size_t off = static_cast<size_t>(blockIdx.y) * snk::kBlock + base;
  const int32_t* S = src + off;
  int32_t* O = out + off;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int q = threadIdx.x + j * kThreads;
    s[q] = S[q];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int q = threadIdx.x + j * kThreads;
    const int v = s[q];
    const int d = v - base;
    O[q] = (d >= 0 && d < kTile) ? s[d] : v;
  }
}

}  // namespace

// src, out: (batch, 65536) int32.
SNK_EXPORT int snk_local_round(const void* src, void* out, int batch,
                               void* stream) {
  dim3 grid(snk::kBlock / kTile, batch);
  local_round_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
