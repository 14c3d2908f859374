// gather_block: y[b, t] = x[b, idx[b, t]], kept to the low 8 * limbs bits;
// 0 where idx lies outside [0, S).
//
// Replaces tpu_snappy/ops/pallas/gather.py:gather_block. The TPU has no
// vector gather, so its kernel splits each index into a 256-row one-hot
// (a row gather on the MXU over pre-scaled 8-bit limb tables) and a
// 256-lane one-hot select; `limbs` is the value width that decomposition
// keeps exact, and a value wider than 8 * limbs bits loses its high limbs,
// which this kernel reproduces with a mask. Hopper has an indexed load, so
// one thread reads one target: no one-hot, no limb tables.
//
// Bound on this card: bytes. The decoder's dense rounds gather 128 rows of
// 65536 int32 pointers from tables of the same size (32 MB a wave, which
// the 50 MB L2 holds); the sidecar gathers 65536 bytes a row from its
// element table. Each target reads its index and one table word and writes
// one word; the table reads are random within a row, so they are served
// by L2, not coalesced. A table in shared memory (u16 at limbs <= 2: 128 KB
// a row) is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ idx,
              int32_t* __restrict__ y, int s, int t, uint32_t mask) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= t) return;
  const size_t row = blockIdx.y;
  const size_t o = row * t + i;
  const int j = idx[o];
  y[o] = (j >= 0 && j < s)
             ? static_cast<int32_t>(static_cast<uint32_t>(
                   __ldg(x + row * s + j)) & mask)
             : 0;
}

}  // namespace

// x: (batch, s) int32 table; idx, y: (batch, t) int32; 1 <= limbs <= 3.
SNK_EXPORT int snk_gather(const void* x, const void* idx, void* y, int s,
                          int t, int limbs, int batch, void* stream) {
  const uint32_t mask = (1u << (8 * limbs)) - 1u;
  dim3 grid((t + kThreads - 1) / kThreads, batch);
  gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(idx),
      static_cast<int32_t*>(y), s, t, mask);
  return static_cast<int>(cudaGetLastError());
}
