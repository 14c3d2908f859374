// window_keys: the encode pair-sort key of every position.
//
// Replaces tpu_snappy/ops/pallas/windows.py:window_keys_block, the fused
// VMEM pass over (16, 128) tiles with a one-tile halo. Here one thread
// owns one position: it reads bytes i..i+3 of its row, wrapping mod 65536
// exactly as jnp.roll and the halo of the last tile do, and writes the
// little-endian u32 window as int64, or 0xFFFFFFFF where i > n - 4.
//
// Bound on this card: bytes. It reads 64 KB and writes 512 KB per row
// (int64 keys, the dtype the port's sort takes), so it is a pure streaming
// pass; the four byte loads of neighbouring threads hit the same L1 lines.
#include "common.cuh"

namespace {

__global__ void window_keys_kernel(const uint8_t* __restrict__ block,
                                   const int32_t* __restrict__ n,
                                   int64_t* __restrict__ key) {
  const int row = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= snk::kBlock) return;
  const uint8_t* b = block + static_cast<size_t>(row) * snk::kBlock;
  const int m = snk::kBlock - 1;
  const uint32_t w = static_cast<uint32_t>(b[i])
                   | static_cast<uint32_t>(b[(i + 1) & m]) << 8
                   | static_cast<uint32_t>(b[(i + 2) & m]) << 16
                   | static_cast<uint32_t>(b[(i + 3) & m]) << 24;
  const bool valid = i <= n[row] - 4;
  key[static_cast<size_t>(row) * snk::kBlock + i] =
      valid ? static_cast<int64_t>(w) : static_cast<int64_t>(0xFFFFFFFFu);
}

}  // namespace

// block: (batch, 65536) uint8; n: (batch,) int32; key: (batch, 65536) int64.
SNK_EXPORT int snk_window_keys(const void* block, const void* n, void* key,
                               int batch, void* stream) {
  const int threads = 256;
  dim3 grid(snk::kBlock / threads, batch);
  window_keys_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(block), static_cast<const int32_t*>(n),
      static_cast<int64_t*>(key));
  return static_cast<int>(cudaGetLastError());
}
