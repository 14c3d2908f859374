// Shared helpers for the tpu_snappy_torch kernels.
//
// Every entry point is `extern "C"`, takes raw device pointers, the batch
// size and the CUDA stream from the Python wrapper, launches on that
// stream, allocates nothing, and returns cudaGetLastError().
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define SNK_EXPORT extern "C" __attribute__((visibility("default")))

namespace snk {

constexpr int kBlock = 1 << 16;  // 64 KB Snappy block / fragment output

// Entry j of a table row of s words through the read-only path, kept to
// `mask`; 0 where j lies outside [0, s) (the TPU's one-hot gather finds no
// row there). The indexed loads of gather_block and doubling_round.
__device__ __forceinline__ int take(const int32_t* row, int s, int j,
                                    uint32_t mask) {
  return static_cast<unsigned>(j) < static_cast<unsigned>(s)
             ? static_cast<int>(static_cast<uint32_t>(__ldg(row + j)) & mask)
             : 0;
}

// Inclusive max-scan over one warp.
__device__ __forceinline__ int warp_scan_max(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int o = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v = max(v, o);
  }
  return v;
}

// Inclusive min-scan over one warp.
__device__ __forceinline__ int warp_scan_min(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int o = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v = min(v, o);
  }
  return v;
}

// Inclusive sum-scan over one warp.
__device__ __forceinline__ int warp_scan_sum(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int o = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += o;
  }
  return v;
}

}  // namespace snk
