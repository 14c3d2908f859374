// cumsum_block and next_start_block: the two whole-row prefix scans.
//
// Replaces tpu_snappy/ops/pallas/scans.py:cumsum_block (the inclusive
// int32 prefix sum) and next_start_block (for each i, the smallest j > i
// whose flag is set, min-reduced with `default`). The TPU kernels hold a
// whole row in VMEM as (rows, 128) and run log2(m) roll-and-combine
// levels over it. A 64K-entry int32 row is 256 KB, more than the 227 KB
// of shared memory a block can have, so here one block walks its row in
// tiles of 4096 entries (one 16-byte load of 4 int32, or one 4-byte load
// of 4 flags, a thread): a scan of the thread's 4 entries, a warp scan
// with shuffles, a scan of the 32 warp totals in shared memory, and a
// carry in a register from one tile to the next. The last tile may be
// ragged (m = 384 is a multiple of 128 but not of 4096); lanes past the
// row load the identity and store nothing.
//
// The sum wraps as int32, as the TPU kernel's does: it is accumulated in
// uint32_t (signed overflow is undefined in C++) and cast back.
// next_start_block walks its row from the end leftwards with a running
// min that starts at `default`, so `default` enters every position, as
// in the TPU kernel (which is why it differs from scan.next_element_start
// where default < m - 1 and every later position is flagged).
//
// Bound on this card: bytes. At (128, 65536) the cumsum reads and writes
// 33.5 MB each, next_start reads 8.4 MB of flags and writes 33.5 MB. One
// block a row walks 16 tiles in series, so at 128 rows each row's latency
// sets the time.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
cumsum_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
              int m) {
  __shared__ uint32_t warp_sum[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row = static_cast<size_t>(blockIdx.x) * m;
  const int4* X = reinterpret_cast<const int4*>(x + row);
  int4* O = reinterpret_cast<int4*>(out + row);
  const int quads = m / 4;
  uint32_t carry = 0;
  for (int base = 0; base < quads; base += kThreads) {
    const int g = base + threadIdx.x;
    uint32_t a = 0, b = 0, c = 0, d = 0;
    if (g < quads) {
      const int4 v = X[g];
      a = v.x;
      b = v.y;
      c = v.z;
      d = v.w;
    }
    b += a;
    c += b;
    d += c;
    // Inclusive warp scan of the thread totals.
    uint32_t t = d;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const uint32_t o = __shfl_up_sync(0xffffffffu, t, s);
      if (lane >= s) t += o;
    }
    if (lane == 31) warp_sum[warp] = t;
    __syncthreads();
    if (warp == 0) {
      uint32_t w = warp_sum[lane];
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const uint32_t o = __shfl_up_sync(0xffffffffu, w, s);
        if (lane >= s) w += o;
      }
      warp_sum[lane] = w;
    }
    __syncthreads();
    const uint32_t before = carry + (t - d) + (warp ? warp_sum[warp - 1] : 0u);
    if (g < quads) {
      O[g] = make_int4(static_cast<int>(before + a),
                       static_cast<int>(before + b),
                       static_cast<int>(before + c),
                       static_cast<int>(before + d));
    }
    carry += warp_sum[kWarps - 1];
    __syncthreads();  // warp_sum is rewritten by the next tile
  }
}

__global__ void __launch_bounds__(kThreads)
next_start_kernel(const uint8_t* __restrict__ flags,
                  int32_t* __restrict__ out, int m, int dflt) {
  __shared__ int warp_min[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row = static_cast<size_t>(blockIdx.x) * m;
  const uchar4* F = reinterpret_cast<const uchar4*>(flags + row);
  int4* O = reinterpret_cast<int4*>(out + row);
  const int quads = m / 4;
  const int tiles = (quads + kThreads - 1) / kThreads;
  int carry = dflt;  // min over everything right of the current tile
  for (int tile = tiles - 1; tile >= 0; --tile) {
    const int g = tile * kThreads + threadIdx.x;
    const int p = 4 * g;
    int a = INT_MAX, b = INT_MAX, c = INT_MAX, d = INT_MAX;
    if (g < quads) {
      const uchar4 f = F[g];
      a = f.x ? p : INT_MAX;
      b = f.y ? p + 1 : INT_MAX;
      c = f.z ? p + 2 : INT_MAX;
      d = f.w ? p + 3 : INT_MAX;
    }
    const int own = min(min(a, b), min(c, d));
    // Inclusive suffix min over the warp's lanes (lane .. 31).
    int t = own;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int o = __shfl_down_sync(0xffffffffu, t, s);
      if (lane + s < 32) t = min(t, o);
    }
    if (lane == 0) warp_min[warp] = t;
    __syncthreads();
    if (warp == 0) {
      int w = warp_min[lane];
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int o = __shfl_down_sync(0xffffffffu, w, s);
        if (lane + s < 32) w = min(w, o);
      }
      warp_min[lane] = w;
    }
    __syncthreads();
    // Min over every position right of this thread's four.
    int right = __shfl_down_sync(0xffffffffu, t, 1);
    if (lane == 31) right = INT_MAX;
    if (warp + 1 < kWarps) right = min(right, warp_min[warp + 1]);
    right = min(right, carry);
    if (g < quads) {
      const int r3 = right;
      const int r2 = min(r3, d);
      const int r1 = min(r2, c);
      const int r0 = min(r1, b);
      O[g] = make_int4(r0, r1, r2, r3);
    }
    carry = min(carry, warp_min[0]);
    __syncthreads();  // warp_min is rewritten by the next tile
  }
}

}  // namespace

// x, out: (batch, m) int32, m a multiple of 4, rows 16-byte aligned.
SNK_EXPORT int snk_cumsum(const void* x, void* out, int m, int batch,
                          void* stream) {
  cumsum_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), m);
  return static_cast<int>(cudaGetLastError());
}

// flags: (batch, m) uint8, nonzero = set; out: (batch, m) int32; m a
// multiple of 4, rows 4-byte (flags) and 16-byte (out) aligned.
SNK_EXPORT int snk_next_start(const void* flags, void* out, int m,
                              int dflt, int batch, void* stream) {
  next_start_kernel<<<batch, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(flags), static_cast<int32_t*>(out), m,
      dflt);
  return static_cast<int>(cudaGetLastError());
}
