// resolve_block: out[p] = lit[fix(src)[p]], fix = src iterated to its
// fixed point by pointer doubling (at most 16 rounds), for (batch, 65536)
// maps with 0 <= src[p] <= p, in one launch.
//
// Replaces tpu_snappy/ops/pallas/resolve.py:resolve_block, the decoder's
// resolve="kernel". The TPU kernel keeps the map in VMEM across rounds,
// gathers each 1024-target tile with one-hot MXU products over 8-bit limb
// snapshots, skips tiles that went stable (every pointer at a fixed point,
// which never moves again), and ends with the byte gather. Here the map
// lives in shared memory as uint16 (values < 65536): 128 KB per row, past
// the 48 KB static limit, so the launch opts in to dynamic shared memory.
// An int32 map (256 KB) would not fit in the 227 KB a block may use.
//
// The TPU computes the synchronous s o s (a per-round snapshot); a
// snapshot here would need a second 128 KB copy. This kernel doubles in
// place instead: a lane may read a pointer another lane already advanced
// in the same round. For src[p] <= p every value a lane reads is still on
// its own chain toward the one fixed point, and at least as far along as
// the snapshot's, so in-place doubling reaches the same fixed point in no
// more rounds, and a round in which no lane moved proves it reached. The
// bytes are therefore the TPU's. The wrapper documents the precondition.
//
// Design: one block of 1024 threads per row, one thread per target of the
// current tile; each tile ends with __syncthreads_or of its lanes' moves,
// which sets its stable flag (in shared memory) and the round's `changed`.
// The byte gather reads lit from device memory.
//
// Bound on this card: the serial walk (rounds x 64 tiles x one barrier)
// with one block per row; the traffic (lit, src, out: 768 KB per row) is
// small.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kTileSize = 1024;
constexpr int kTiles = snk::kBlock / kTileSize;
constexpr int kMaxRounds = 16;
constexpr int kSmem = snk::kBlock * static_cast<int>(sizeof(uint16_t));

__global__ void __launch_bounds__(kThreads)
resolve_block_kernel(const int32_t* __restrict__ lit,
                     const int32_t* __restrict__ src, int32_t* out) {
  extern __shared__ uint16_t s[];
  __shared__ int stable[kTiles];
  const size_t row = static_cast<size_t>(blockIdx.x) * snk::kBlock;
  const int32_t* L = lit + row;
  const int32_t* S = src + row;
  int32_t* O = out + row;
  for (int p = threadIdx.x; p < snk::kBlock; p += kThreads)
    s[p] = static_cast<uint16_t>(S[p]);
  if (threadIdx.x < kTiles) stable[threadIdx.x] = 0;
  __syncthreads();
  for (int r = 0; r < kMaxRounds; ++r) {
    int changed = 0;
    for (int t = 0; t < kTiles; ++t) {
      if (stable[t]) continue;  // uniform: written before a barrier
      const int p = t * kTileSize + threadIdx.x;
      const int v = s[p];
      const int w = s[v];
      if (w != v) s[p] = static_cast<uint16_t>(w);
      const int moved = __syncthreads_or(w != v);
      if (threadIdx.x == 0) stable[t] = !moved;
      changed |= moved;
    }
    __syncthreads();  // the stable flags, for the next round's skips
    if (!changed) break;
  }
  for (int p = threadIdx.x; p < snk::kBlock; p += kThreads) O[p] = L[s[p]];
}

}  // namespace

// lit, src, out: (batch, 65536) int32.
SNK_EXPORT int snk_resolve_block(const void* lit, const void* src, void* out,
                                 int batch, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      resolve_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  resolve_block_kernel<<<batch, kThreads, kSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lit), static_cast<const int32_t*>(src),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
