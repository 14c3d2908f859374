// gather_window_block: y[p] = x[idx[p]] (low 8 * limbs bits) where idx[p]
// lies in the k x 2048-position window ending with p's 2048-position tile,
// else y[p] = idx[p]; for maps with 0 <= idx[p] <= p.
//
// Replaces tpu_snappy/ops/pallas/gatherw.py:gather_window_block, the
// opening rounds of the decoder's resolve="windowed". The TPU has no
// vector gather, so its kernel passes the table as k overlapping chunk
// views per grid step and builds a one-hot over the window's rows, which
// costs rows x window MACs instead of the full table's. Hopper has an
// indexed load, for which a window saves nothing: one thread per target
// tests the window and reads one word. An index at or past the end of p's
// tile (outside the precondition) gives 0, as the TPU's one-hot does.
//
// Bound on this card: bytes. At the decoder's (128, 65536) wave, from
// itself, it reads the map once and writes it once (67 MB); the table
// reads hit a window of at most 128 KB below each target, served by L2.
// A k=16 window is 128 KB per tile, too much shared memory to stage.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 2048;

__global__ void __launch_bounds__(kThreads)
gather_window_kernel(const int32_t* __restrict__ x,
                     const int32_t* __restrict__ idx, int32_t* __restrict__ y,
                     int k, uint32_t mask) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.y) * snk::kBlock;
  const int j = idx[row + p];
  const int tile = p / kChunk;
  const int lo = (tile - (k - 1)) * kChunk;
  const int end = (tile + 1) * kChunk;
  int32_t v;
  if (j < lo) {
    v = j;
  } else if (j >= 0 && j < end) {
    v = static_cast<int32_t>(static_cast<uint32_t>(__ldg(x + row + j)) & mask);
  } else {
    v = 0;
  }
  y[row + p] = v;
}

}  // namespace

// x, idx, y: (batch, 65536) int32; k >= 1; 1 <= limbs <= 3.
SNK_EXPORT int snk_gather_window(const void* x, const void* idx, void* y,
                                 int k, int limbs, int batch, void* stream) {
  const uint32_t mask = (1u << (8 * limbs)) - 1u;
  dim3 grid(snk::kBlock / kThreads, batch);
  gather_window_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(idx),
      static_cast<int32_t*>(y), k, mask);
  return static_cast<int>(cudaGetLastError());
}
