// place: monotone-destination byte placement of the encoder's main lane.
//
// Replaces tpu_snappy/ops/pallas/place.py:place_block. The TPU kernel
// builds bf16 one-hots over a 32 x 128 window per 1024-source tile and
// multiplies them on the MXU, because that chip has no vector scatter.
// What it computes, and what this kernel keeps exactly:
//   * per 1024-source tile, m = min active dest (active: dest < cap, and
//     here also dest >= 0), base = min((m >> 10) << 3, out_rows - 32) in
//     128-cell rows;
//   * a write with (dest >> 7) - base >= 32 is dropped and counted;
//   * the rest add into out[dest] (duplicates sum).
// One block per source tile takes the block minimum, then every thread
// adds its value with an integer atomic straight into the output row,
// which the wrapper zeroes. The encoder's destinations are distinct and
// increasing, so the atomics do not collide.
//
// Bound on this card: bytes. A source reads 8 bytes; the output row is
// written once (zeroed, then one add per active source).
#include "common.cuh"

#include <climits>

namespace {

constexpr int kTile = 1024;  // sources per window (the TPU kernel's grid step)
constexpr int kW = 32;       // window rows

__global__ void __launch_bounds__(kTile)
place_kernel(const int32_t* __restrict__ dest,
             const int32_t* __restrict__ vals, int m, int out_rows,
             int32_t* __restrict__ out, int32_t* __restrict__ ovf) {
  __shared__ int warp_min[32];
  const int row = blockIdx.y;
  const int cap = out_rows * 128;
  const size_t src = static_cast<size_t>(row) * m
                   + static_cast<size_t>(blockIdx.x) * kTile + threadIdx.x;
  const int d = dest[src];
  const bool active = d >= 0 && d < cap;
  const int wmin = __reduce_min_sync(0xffffffffu, active ? d : INT_MAX);
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = wmin;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int t = __reduce_min_sync(0xffffffffu, warp_min[threadIdx.x]);
    if (threadIdx.x == 0) warp_min[0] = t;
  }
  __syncthreads();
  if (!active) return;
  const int base = min((warp_min[0] >> 10) << 3, out_rows - kW);
  if ((d >> 7) - base >= kW) {
    atomicAdd(ovf + row, 1);
    return;
  }
  atomicAdd(out + static_cast<size_t>(row) * cap + d, vals[src]);
}

}  // namespace

// dest, vals: (batch, m) int32, m a multiple of 1024; out: zeroed (batch,
// out_rows * 128) int32; ovf: zeroed (batch,) int32 drop counts;
// out_rows >= 32.
SNK_EXPORT int snk_place(const void* dest, const void* vals, void* out,
                         void* ovf, int m, int out_rows, int batch,
                         void* stream) {
  dim3 grid(m / kTile, batch);
  place_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(dest), static_cast<const int32_t*>(vals), m,
      out_rows, static_cast<int32_t*>(out), static_cast<int32_t*>(ovf));
  return static_cast<int>(cudaGetLastError());
}
