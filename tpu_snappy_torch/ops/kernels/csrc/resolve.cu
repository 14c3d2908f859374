// resolve_block: out[p] = lit[fix(src)[p]], fix = src iterated to its
// fixed point by pointer doubling, for (batch, 65536) maps with
// 0 <= src[p] <= p and byte values in lit, in one launch.
//
// Replaces tpu_snappy/ops/pallas/resolve.py:resolve_block, the decoder's
// resolve="kernel". The TPU kernel keeps the map in VMEM across rounds
// (at most 16: a chain is shorter than 65536 = 2^16 hops), gathers each
// 1024-target tile with one-hot MXU products over 8-bit limb snapshots,
// skips tiles that went stable (every pointer at a fixed point, which
// never moves again), and ends with the byte gather.
//
// In-place doubling. The TPU computes the synchronous s o s (a per-round
// snapshot); a snapshot here would need a second copy of the map. This
// kernel doubles in place instead: a thread may read a pointer another
// thread already advanced in the same round. For src[p] <= p every value
// read is still on the reader's chain toward its one fixed point, and at
// least as far along as the snapshot's, so in-place doubling reaches the
// same fixed point in no more rounds (at most 16), and a round in which no
// pointer moved proves it reached. Only pointers that are not roots are
// ever written, so a position q with s[q] == q is a root for good. The
// bytes are therefore the TPU's.
//
// Design: one block of 1024 threads a row, 192 KB of dynamic shared
// memory: the map as uint16 (values < 65536; 128 KB) and, for the end, the
// row's bytes (64 KB).
//   1. The map is loaded with 16-byte loads, eight in flight a thread,
//      narrowed to uint16; then lit is prefetched into L2, so that it
//      crosses from device memory while the rounds run.
//   2. Rounds over the whole row, one barrier each (__syncthreads_or of
//      the round's moves). Thread t holds pairs t + 1024 k (k < 32) of
//      positions in registers, so a warp's pairs are 64 consecutive
//      positions (its own reads and writes are one 128-byte wavefront, and
//      the copies' gathers, p - offset over a run, hit distinct banks).
//      A bit a pair marks the pairs still moving: a pair whose two
//      pointers are roots (a round read s[v] == v for both) is skipped
//      from then on, and a slot no lane of a warp needs costs the warp
//      one branch. Pairs whose positions are roots from the start
//      (literal bytes) are never visited.
//   3. lit's bytes, from L2, into the byte plane (16-byte loads), then
//      out[p] = b[s[p]] as int32 with 8-byte stores of each pair, a warp
//      writing 256 contiguous bytes.
// A thread visits its slots in position order, so a pointer into an
// earlier slot often reads a value already advanced this round, and copy
// chains settle in fewer rounds than synchronous doubling's.
//
// Bound on this card: the row's bytes (lit, src, out: 768 KB a row) at a
// 128-row wave; the rounds' shared-memory gathers, one block a row, at the
// server's 8-row waves. The whole-row design replaces the parent's walk of
// 64 tiles in series a round (a barrier a tile), and, against the tiled
// resolve (csrc/tiledres.cu, the same function for src[p] <= p), runs no
// per-tile local rounds and no merge levels. Its times are in PERF.md.
#include "common.cuh"

namespace {

constexpr int kN = snk::kBlock;
constexpr int kThreads = 1024;
constexpr int kPairs = kN / 2 / kThreads;  // pair slots a thread
constexpr int kQuads = kN / 4 / kThreads;  // 16-byte loads a thread
constexpr int kMaxRounds = 16;
// The row's map (uint16), then its bytes (uint8).
constexpr int kSmem = kN * static_cast<int>(sizeof(uint16_t)) + kN;

__device__ __forceinline__ uint32_t pack2(int lo, int hi) {
  return (static_cast<uint32_t>(lo) & 0xffffu) |
         (static_cast<uint32_t>(hi) << 16);
}

// s[p] = src[p] as uint16, 16 bytes a load, eight loads a thread in
// flight.
__device__ __forceinline__ void load_map(const int32_t* __restrict__ S,
                                         uint16_t* s) {
  const int4* S4 = reinterpret_cast<const int4*>(S);
  uint2* s4 = reinterpret_cast<uint2*>(s);
  constexpr int kBatch = 8;
#pragma unroll 1
  for (int h = 0; h < kQuads; h += kBatch) {
    int4 x[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      x[j] = __ldcs(S4 + threadIdx.x + (h + j) * kThreads);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      s4[threadIdx.x + (h + j) * kThreads] =
          make_uint2(pack2(x[j].x, x[j].y), pack2(x[j].z, x[j].w));
  }
}

// lit's 128-byte lines into L2, behind the map load.
__device__ __forceinline__ void prefetch_lit(const int32_t* __restrict__ L) {
  constexpr int kLines = kN * 4 / 128;
#pragma unroll
  for (int k = threadIdx.x; k < kLines; k += kThreads)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(L + 32 * k));
}

// b[p] = lit[p] as a byte, 16 bytes a load, from L2 after prefetch_lit.
__device__ __forceinline__ void load_bytes(const int32_t* __restrict__ L,
                                           uint8_t* b) {
  const int4* L4 = reinterpret_cast<const int4*>(L);
  uint32_t* b4 = reinterpret_cast<uint32_t*>(b);
  constexpr int kBatch = 8;
#pragma unroll 1
  for (int h = 0; h < kQuads; h += kBatch) {
    int4 y[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      y[j] = __ldcs(L4 + threadIdx.x + (h + j) * kThreads);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      b4[threadIdx.x + (h + j) * kThreads] =
          (static_cast<uint32_t>(y[j].x) & 0xffu) |
          (static_cast<uint32_t>(y[j].y) & 0xffu) << 8 |
          (static_cast<uint32_t>(y[j].z) & 0xffu) << 16 |
          static_cast<uint32_t>(y[j].w) << 24;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
resolve_block_kernel(const int32_t* __restrict__ lit,
                     const int32_t* __restrict__ src,
                     int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* s = reinterpret_cast<uint16_t*>(smem);
  uint8_t* b = smem + kN * sizeof(uint16_t);
  uint32_t* s2 = reinterpret_cast<uint32_t*>(s);
  const size_t row = static_cast<size_t>(blockIdx.x) * kN;
  load_map(src + row, s);
  __syncthreads();
  prefetch_lit(lit + row);
  uint32_t pr[kPairs];  // pair t + 1024 k: positions 2 i and 2 i + 1
  uint32_t act = 0;     // bit k: pair k may still move
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int i = threadIdx.x + k * kThreads;
    pr[k] = s2[i];
    if (pr[k] != pack2(2 * i, 2 * i + 1)) act |= 1u << k;
  }
  for (int r = 0; r < kMaxRounds; ++r) {
    int moved = 0;
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      if (!(act >> k & 1)) continue;
      const uint32_t nv = pack2(s[pr[k] & 0xffffu], s[pr[k] >> 16]);
      if (nv != pr[k]) {
        pr[k] = nv;
        s2[threadIdx.x + k * kThreads] = nv;
        moved = 1;
      } else {
        act &= ~(1u << k);  // both pointers are roots
      }
    }
    if (!__syncthreads_or(moved)) break;
  }
  load_bytes(lit + row, b);
  __syncthreads();
  int2* O2 = reinterpret_cast<int2*>(out + row);
#pragma unroll
  for (int k = 0; k < kPairs; ++k)
    __stcs(O2 + threadIdx.x + k * kThreads,
           make_int2(b[pr[k] & 0xffffu], b[pr[k] >> 16]));
}

}  // namespace

// lit, src, out: (batch, 65536) int32, 16-byte aligned; lit holds bytes.
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
