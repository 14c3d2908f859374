// cumsum_block and next_start_block: the two whole-row prefix scans.
//
// Replaces tpu_snappy/ops/pallas/scans.py:cumsum_block (the inclusive
// int32 prefix sum) and next_start_block (for each i, the smallest j > i
// whose flag is set, min-reduced with `default`). The TPU kernels hold a
// whole row in VMEM as (rows, 128) and run log2(m) roll-and-combine
// levels over it.
//
// cumsum_block: a 64K-entry int32 row is 256 KB, more than the 227 KB of
// shared memory a block can have, so one block walks its row in tiles of
// 4096 entries (one 16-byte load of 4 int32 a thread): a scan of the
// thread's 4 entries, a warp scan with shuffles, a scan of the 32 warp
// totals in shared memory, and a carry in a register from one tile to the
// next. The last tile may be ragged (m = 384 is a multiple of 128 but not
// of 4096); lanes past the row load the identity and store nothing. The
// sum wraps as int32, as the TPU kernel's does: it is accumulated in
// uint32_t (signed overflow is undefined in C++) and cast back.
//
// next_start_block: `default` enters every position, as in the TPU kernel
// (which is why it differs from scan.next_element_start where default <
// m - 1 and every later position is flagged). The scan is a suffix min,
// and each position's answer depends only on the flags right of it, so a
// row splits into spans of kSpan = 4096 positions, one 256-thread block a
// span (16 flags a thread from one 16-byte load), and no block waits for
// another:
//   * inside the span: a 16-bit mask of the thread's set flags, a ballot
//     for the lanes right of it, and each warp's first set position in
//     shared memory;
//   * the carry, the first set flag right of the span: warp 0 reads the
//     kAhead = 512 flags past the span's end (one 16-byte load a lane,
//     issued with the span's own load) and takes the first set one by
//     ballot. If none is set, the block reads on in steps of 4 x kSpan
//     flags (four loads a thread), one barrier a step, until a set flag,
//     the row's end or `default` (a flag at or past `default` cannot
//     lower any answer). Dense rows stop at the first step; an all-zero
//     row reads its tail once a block, from L2;
//   * the output: each thread's 16 answers staged in shared memory
//     (swizzled by thread pairs, so neither side's 16-byte accesses
//     conflict) and written back with 16-byte stores, a warp's store one
//     contiguous 512-byte run.
// The last span may be ragged (m = 384 and 57344 are not multiples of
// 4096); threads past the row load nothing and store nothing.
//
// Bound on this card: bytes. At (128, 65536) the cumsum reads and writes
// 33.5 MB each; next_start reads 8.4 MB of flags and writes 33.5 MB over
// 2048 blocks, which fill every SM. A 1-D row of 65536 takes 16 blocks.
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

// next_start_block's spans: kSpanThreads threads of 16 flags each.
constexpr int kSpanThreads = 256;
constexpr int kSpan = 16 * kSpanThreads;
constexpr int kSpanWarps = kSpanThreads / 32;
constexpr int kAhead = 512;
constexpr int kStep = 4 * kSpan;

// Bit u set where byte u of w is nonzero.
__device__ __forceinline__ uint32_t nonzero4(uint32_t w) {
  const uint32_t t = __vcmpne4(w, 0u);  // 0xff in each nonzero byte
  return ((t >> 7) & 1u) | ((t >> 14) & 2u) | ((t >> 21) & 4u) |
         ((t >> 28) & 8u);
}

__device__ __forceinline__ uint32_t nonzero16(uint4 f) {
  return nonzero4(f.x) | nonzero4(f.y) << 4 | nonzero4(f.z) << 8 |
         nonzero4(f.w) << 12;
}

// The first set position in the warp's 16-flag groups (lane l's group
// starts at `base`, its set flags in `msk`); INT_MAX if none.
__device__ __forceinline__ int warp_first(uint32_t msk, int base) {
  const uint32_t any = __ballot_sync(~0u, msk != 0);
  const int pos = msk ? base + __ffs(msk) - 1 : INT_MAX;
  const int got = __shfl_sync(~0u, pos, any ? __ffs(any) - 1 : 0);
  return any ? got : INT_MAX;
}

__global__ void __launch_bounds__(kSpanThreads)
next_start_kernel(const uint8_t* __restrict__ flags,
                  int32_t* __restrict__ out, int m, int dflt, int spans) {
  __shared__ int firsts[kSpanWarps];
  __shared__ int carry_s;
  __shared__ int found[3];
  __shared__ __align__(16) int4 stage[kSpan / 4];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x / spans;
  const int start = (blockIdx.x - row * spans) * kSpan;
  const int end = min(start + kSpan, m);
  const uint8_t* F = flags + static_cast<size_t>(row) * m;
  int32_t* O = out + static_cast<size_t>(row) * m;
  const int base = start + 16 * threadIdx.x;  // this thread's 16 flags
  // A flag at or past `default`, or past the row, lowers no answer.
  const bool want_carry = dflt > end && end < m;
  uint4 f = make_uint4(0, 0, 0, 0), g = make_uint4(0, 0, 0, 0);
  if (base < m) f = __ldcs(reinterpret_cast<const uint4*>(F + base));
  const int ahead = end + 16 * lane;
  if (warp == 0 && want_carry && ahead < m)
    g = __ldg(reinterpret_cast<const uint4*>(F + ahead));
  const uint32_t msk = nonzero16(f);
  // The first set position in the lanes right of this one.
  const uint32_t any = __ballot_sync(~0u, msk != 0);
  const uint32_t right_lanes = lane == 31 ? 0u : any & (0xfffffffeu << lane);
  const int mine = msk ? base + __ffs(msk) - 1 : INT_MAX;
  int right = __shfl_sync(~0u, mine, right_lanes ? __ffs(right_lanes) - 1
                                                 : lane);
  if (!right_lanes) right = INT_MAX;
  const int first = warp_first(msk, base);
  if (lane == 0) firsts[warp] = first;
  if (warp == 0) {
    const int c = want_carry ? warp_first(nonzero16(g), ahead) : INT_MAX;
    if (lane == 0) carry_s = c;
  }
  if (threadIdx.x == 0) found[0] = INT_MAX;
  __syncthreads();
  int carry = carry_s;
  if (want_carry && carry == INT_MAX && end + kAhead < m) {
    // Step st collects its first set flag in found[st % 3] and clears the
    // next step's slot before its barrier: that slot's last readers
    // passed the barrier before, and its next writers come after this
    // one.
    const int lim = min(m, dflt);
    int st = 0;
    for (int pos = end + kAhead; pos < lim; pos += kStep, ++st) {
      int c = INT_MAX;  // the lowest u with a set flag wins
#pragma unroll
      for (int u = kStep / kSpan - 1; u >= 0; --u) {
        const int at = pos + 16 * (threadIdx.x + u * kSpanThreads);
        if (at < m) {
          const uint32_t hm =
              nonzero16(__ldg(reinterpret_cast<const uint4*>(F + at)));
          if (hm) c = at + __ffs(hm) - 1;
        }
      }
      if (c != INT_MAX) atomicMin(&found[st % 3], c);
      if (threadIdx.x == 0) found[(st + 1) % 3] = INT_MAX;
      __syncthreads();
      const int best = found[st % 3];
      if (best != INT_MAX) {
        carry = best;
        break;
      }
    }
  }
#pragma unroll
  for (int w = 0; w < kSpanWarps; ++w)
    if (w > warp) right = min(right, firsts[w]);
  // Right to left through the thread's 16 positions.
  int nxt = min(min(right, carry), dflt);
  int o[16];
#pragma unroll
  for (int k = 15; k >= 0; --k) {
    o[k] = nxt;
    if (msk >> k & 1) nxt = min(base + k, dflt);
  }
  // Thread t's quads 4 t .. 4 t + 3 go to stage slots 4 t + (k ^ sw(t)).
  const int sw = (threadIdx.x >> 1) & 3;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    stage[4 * threadIdx.x + (k ^ sw)] =
        make_int4(o[4 * k], o[4 * k + 1], o[4 * k + 2], o[4 * k + 3]);
  __syncthreads();
  int4* O4 = reinterpret_cast<int4*>(O + start);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int q = threadIdx.x + k * kSpanThreads;  // quad of the span
    const int owner = q >> 2;
    if (start + 4 * q < m)
      __stcs(O4 + q, stage[4 * owner + ((q & 3) ^ ((owner >> 1) & 3))]);
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
// multiple of 16, rows 16-byte aligned.
SNK_EXPORT int snk_next_start(const void* flags, void* out, int m,
                              int dflt, int batch, void* stream) {
  const int spans = (m + kSpan - 1) / kSpan;
  next_start_kernel<<<batch * spans, kSpanThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(flags), static_cast<int32_t*>(out), m,
      dflt, spans);
  return static_cast<int>(cudaGetLastError());
}
