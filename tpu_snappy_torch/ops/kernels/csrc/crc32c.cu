// crc32c_rows: the CRC-32C (Castagnoli, bit-reflected, init and final xor
// 0xFFFFFFFF, unmasked) of the first lengths[r] bytes of every 65536-byte
// row r, the value the framed container masks into each data chunk.
//
// Replaces no TPU kernel: the JAX package computes the container's CRC-32C
// on the host (numpy slice-by-8 over the chunks). Here the chunks are
// already on the card, as the rows the encoder reads, so the CRCs are
// computed there and the host fetches 8 bytes a row.
//
// Bound on this card: bytes. A call reads B x 65536 bytes once (64 MiB at
// a 1024-row call: 0.020 ms at 3.35 TB/s) and writes 8 bytes a row. The
// design keeps every byte to one read and one table lookup:
//  * one CTA a row (a grid-stride loop past 8 CTAs an SM); each of its 256
//    threads takes one contiguous 256-byte segment, read with 16-byte
//    loads, and runs a zero-initialised slice-by-16 CRC over it from
//    tables in shared memory (16 KB, one lookup a byte);
//  * CRC-32C is linear over GF(2) once init and final xor are set aside,
//    so a segment's register moves to the row's end with one
//    multiplication by x^(8 x the bytes after it) mod P, and the row's
//    register is the xor of the 256 products (warp shuffles, then 8
//    words of shared memory): no serial pass over the row;
//  * the length: every row runs the same loop over its full width with
//    the bytes at or past n taken as zero (a segment that starts past n
//    loads nothing), which leaves the register times x^(8(65536 - n));
//    thread 0 multiplies by x^(-8(65536 - n)) (one product for each set
//    bit of 65536 - n), after folding in the init's term 0xFFFFFFFF x
//    x^(8 x 65536). Full rows skip the products.
// The constants (tables, each thread's shift, the init's term, the
// inverse powers) come from the wrapper, built once a device
// (ops/kernels/crc.py: constants()), in the order of kShiftAt, kInitAt,
// kInverseAt.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSeg = snk::kBlock / kThreads;  // bytes a thread
constexpr int kSteps = kSeg / 16;             // 16-byte steps a thread
constexpr int kTables = 16;                   // slice-by-16
constexpr int kInverses = 17;                 // x^(-8 * 2^j), j < 17
constexpr int kShiftAt = kTables * 256;
constexpr int kInitAt = kShiftAt + kThreads;
constexpr int kInverseAt = kInitAt + 1;
constexpr int kGridMax = 132 * 8;
constexpr uint32_t kPoly = 0x82F63B78u;

// a * b mod P, bit-reflected (bit 31 is x^0).
__device__ __forceinline__ uint32_t gf_mul(uint32_t a, uint32_t b) {
  uint32_t p = 0;
#pragma unroll
  for (int i = 31; i >= 0; --i) {
    p ^= (0u - ((a >> i) & 1u)) & b;
    b = (b >> 1) ^ ((0u - (b & 1u)) & kPoly);
  }
  return p;
}

// The word w with its bytes at or past `keep` (a count, any int) zeroed.
__device__ __forceinline__ uint32_t keep_bytes(uint32_t w, int keep) {
  return keep >= 4 ? w : keep <= 0 ? 0u : w & ((1u << (8 * keep)) - 1u);
}

__device__ __forceinline__ uint32_t lookup(const uint32_t* t, int j,
                                          uint32_t b) {
  return t[j * 256 + b];
}

// The register r after the 16 bytes of v (little-endian words).
__device__ __forceinline__ uint32_t step16(const uint32_t* t, uint32_t r,
                                           uint4 v) {
  const uint32_t a = v.x ^ r;
  return lookup(t, 15, a & 0xff) ^ lookup(t, 14, (a >> 8) & 0xff) ^
         lookup(t, 13, (a >> 16) & 0xff) ^ lookup(t, 12, a >> 24) ^
         lookup(t, 11, v.y & 0xff) ^ lookup(t, 10, (v.y >> 8) & 0xff) ^
         lookup(t, 9, (v.y >> 16) & 0xff) ^ lookup(t, 8, v.y >> 24) ^
         lookup(t, 7, v.z & 0xff) ^ lookup(t, 6, (v.z >> 8) & 0xff) ^
         lookup(t, 5, (v.z >> 16) & 0xff) ^ lookup(t, 4, v.z >> 24) ^
         lookup(t, 3, v.w & 0xff) ^ lookup(t, 2, (v.w >> 8) & 0xff) ^
         lookup(t, 1, (v.w >> 16) & 0xff) ^ lookup(t, 0, v.w >> 24);
}

__global__ void __launch_bounds__(kThreads, 4)
crc32c_rows_kernel(const uint8_t* __restrict__ blocks,
                   const int32_t* __restrict__ lengths,
                   const uint32_t* __restrict__ consts,
                   int64_t* __restrict__ out, int batch) {
  __shared__ uint32_t table[kTables * 256];
  __shared__ uint32_t part[kThreads / 32];
  const int t = threadIdx.x;
  for (int i = t; i < kTables * 256; i += kThreads) table[i] = consts[i];
  const uint32_t shift = consts[kShiftAt + t];
  __syncthreads();
  const int s0 = t * kSeg;
  for (int row = blockIdx.x; row < batch; row += gridDim.x) {
    const int n = min(max(lengths[row], 0), snk::kBlock);
    uint32_t r = 0;
    if (s0 < n) {
      const uint4* p = reinterpret_cast<const uint4*>(
          blocks + static_cast<size_t>(row) * snk::kBlock + s0);
      if (s0 + kSeg <= n) {
#pragma unroll
        for (int i = 0; i < kSteps; ++i) r = step16(table, r, __ldg(p + i));
      } else {
        for (int i = 0; i < kSteps; ++i) {
          uint4 v = __ldg(p + i);
          const int keep = n - (s0 + 16 * i);
          v.x = keep_bytes(v.x, keep);
          v.y = keep_bytes(v.y, keep - 4);
          v.z = keep_bytes(v.z, keep - 8);
          v.w = keep_bytes(v.w, keep - 12);
          r = step16(table, r, v);
        }
      }
    }
    r = gf_mul(r, shift);
#pragma unroll
    for (int d = 16; d; d >>= 1) r ^= __shfl_xor_sync(0xffffffffu, r, d);
    if ((t & 31) == 0) part[t >> 5] = r;
    __syncthreads();
    if (t == 0) {
      uint32_t c = consts[kInitAt];
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) c ^= part[w];
      const int short_by = snk::kBlock - n;
      for (int j = 0; j < kInverses; ++j)
        if ((short_by >> j) & 1) c = gf_mul(c, consts[kInverseAt + j]);
      out[row] = static_cast<int64_t>(c ^ 0xFFFFFFFFu);
    }
    __syncthreads();  // part[] is rewritten by the next row
  }
}

}  // namespace

// blocks: (batch, 65536) uint8, 16-byte aligned; lengths: (batch,) int32;
// consts: the wrapper's constants (uint32); out: (batch,) int64.
SNK_EXPORT int snk_crc32c_rows(const void* blocks, const void* lengths,
                               const void* consts, void* out, int batch,
                               void* stream) {
  if (batch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = batch < kGridMax ? batch : kGridMax;
  crc32c_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks),
      static_cast<const int32_t*>(lengths),
      static_cast<const uint32_t*>(consts), static_cast<int64_t*>(out),
      batch);
  return static_cast<int>(cudaGetLastError());
}
