// ffill: multi-payload forward fill from the latest set mask position.
//
// Replaces tpu_snappy/ops/pallas/ffill.py:ffill_block, which keeps a whole
// row in VMEM and runs log2(M) Hillis-Steele roll levels. That shape
// answers a chip without a vector gather; this card has one. So the fill
// is an index problem: last[i] = max over j <= i of (mask[j] ? j : -1), a
// max-scan, then out[i] = val[last[i]] (or val[i] where no mask precedes
// i). With the TPU kernel's `max_gap` it runs L = max(1, bit_length(max_gap
// - 1)) roll levels, which fill a position only from a set mask less than
// 2^L behind it: here that is one more test at the gather, i - last[i] <
// window (window = 2^L, or past the row when there is no max_gap).
//
// Bound on this card: bytes. Each payload is read and written once, the
// mask read (here twice: about 11% more at one payload); the gather of
// val[last] falls within a warp on one or two lines, or on one carried
// element. A row is cut into chunks of G x 1024 positions so that every
// SM has blocks, whatever the batch (the wrapper, ffill.py:fill_chunk,
// picks G). Two launches over the grid (chunk, row), no serial walk:
//   1. last_set_kernel: the chunk's latest set index, or -1, into a
//      (batch, chunks) int32 tensor (every entry written, no memset);
//      one 4 G-byte mask load a thread.
//   2. fill_kernel: the carry is the max of the earlier chunks' entries of
//      its row (at most 63, from L2); each thread holds G groups of four
//      positions, group u at u x 1024 + 4 x thread, so that every warp
//      load and store is one contiguous line; a warp-shuffle max-scan of
//      the groups' latest set index, a scan of the warp totals and of the
//      G segments, then the gather and one 16-byte store a group and
//      payload. The payload count (1 to 4) is a template parameter, so
//      the loops unroll. More payloads take one fill_kernel launch for
//      each group of up to four, all reading the one `last` tensor that
//      last_set_kernel wrote.
// A one-pass decoupled look-back scan would read the mask once, but needs
// a status word per chunk that must be reset every call.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;                   // positions a group (one word)
constexpr int kSpan = kThreads * kGroup;    // positions of one segment
constexpr int kLaunchPayloads = 4;  // payloads one fill launch takes

struct Payloads {
  const int32_t* in[kLaunchPayloads];
  int32_t* out[kLaunchPayloads];
};

// The highest set byte of a mask word, as a position, or -1.
__device__ __forceinline__ int last_in_word(uint32_t w, int p0) {
  return w ? p0 + ((31 - __clz(w)) >> 3) : -1;
}

// Grid (chunks, batch). Thread t reads the chunk's bytes [4 G t, 4 G t +
// 4 G) in one load; m is a multiple of 128, so a thread's bytes lie wholly
// inside or past the row.
template <int G>
__global__ void __launch_bounds__(kThreads)
last_set_kernel(const uint8_t* __restrict__ mask, int m, int chunks,
                int* __restrict__ last) {
  __shared__ int warp_max[kWarps];
  const int row = blockIdx.y;
  const int p0 = blockIdx.x * G * kSpan + threadIdx.x * G * kGroup;
  int best = -1;
  if (p0 < m) {
    const uint8_t* at = mask + static_cast<size_t>(row) * m + p0;
    uint32_t w[G];
    if constexpr (G == 4) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(at));
      w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
    } else if constexpr (G == 2) {
      const uint2 x = __ldg(reinterpret_cast<const uint2*>(at));
      w[0] = x.x; w[1] = x.y;
    } else {
      w[0] = __ldg(reinterpret_cast<const uint32_t*>(at));
    }
#pragma unroll
    for (int u = 0; u < G; ++u)
      best = max(best, last_in_word(w[u], p0 + u * kGroup));
  }
  best = __reduce_max_sync(0xffffffffu, best);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) best = max(best, warp_max[w]);
    last[static_cast<size_t>(row) * chunks + blockIdx.x] = best;
  }
}

// Grid (chunks, batch). Group u of thread t covers positions c0 + u x 1024
// + 4 t .. + 3 of the row.
template <int G, int K>
__global__ void __launch_bounds__(kThreads)
fill_kernel(const uint8_t* __restrict__ mask, Payloads p,
            const int* __restrict__ last, int m, int chunks, int window) {
  __shared__ int warp_tot[G][kWarps];
  __shared__ int carry_s;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.y;
  const size_t rbase = static_cast<size_t>(row) * m;
  const int c0 = blockIdx.x * G * kSpan;
  uint32_t w[G];
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const int p0 = c0 + u * kSpan + threadIdx.x * kGroup;
    w[u] = p0 < m ? __ldg(reinterpret_cast<const uint32_t*>(mask + rbase
                                                            + p0))
                  : 0u;
  }
  if (warp == 0) {
    int c = -1;
    for (int j = lane; j < static_cast<int>(blockIdx.x); j += 32)
      c = max(c, __ldg(last + static_cast<size_t>(row) * chunks + j));
    c = __reduce_max_sync(0xffffffffu, c);
    if (lane == 0) carry_s = c;
  }
  int incl[G];
#pragma unroll
  for (int u = 0; u < G; ++u) {
    incl[u] = snk::warp_scan_max(
        last_in_word(w[u], c0 + u * kSpan + threadIdx.x * kGroup));
    if (lane == 31) warp_tot[u][warp] = incl[u];
  }
  __syncthreads();
  int before = carry_s;  // latest set index before segment u
#pragma unroll
  for (int u = 0; u < G; ++u) {
    int prev = __shfl_up_sync(0xffffffffu, incl[u], 1);
    if (lane == 0) prev = -1;
    int seg = -1, ahead = -1;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const int tot = warp_tot[u][v];
      seg = max(seg, tot);
      if (v < warp) ahead = max(ahead, tot);
    }
    int l = max(before, max(ahead, prev));
    before = max(before, seg);
    const int p0 = c0 + u * kSpan + threadIdx.x * kGroup;
    if (p0 >= m) continue;
    int src[kGroup];
#pragma unroll
    for (int e = 0; e < kGroup; ++e) {
      if ((w[u] >> (8 * e)) & 0xFFu) l = p0 + e;
      src[e] = l >= 0 && p0 + e - l < window ? l : p0 + e;
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int32_t* in = p.in[j] + rbase;
      const int4 o = make_int4(__ldg(in + src[0]), __ldg(in + src[1]),
                               __ldg(in + src[2]), __ldg(in + src[3]));
      *reinterpret_cast<int4*>(p.out[j] + rbase + p0) = o;
    }
  }
}

template <int G, int K>
int launch_fill(const uint8_t* mask, const Payloads& p, int* last,
                bool find_last, int m, int chunks, int window, int batch,
                cudaStream_t s) {
  const dim3 grid(chunks, batch);
  if (find_last) {
    last_set_kernel<G><<<grid, kThreads, 0, s>>>(mask, m, chunks, last);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fill_kernel<G, K><<<grid, kThreads, 0, s>>>(mask, p, last, m, chunks,
                                               window);
  return static_cast<int>(cudaGetLastError());
}

template <int G>
int launch_fill_k(const uint8_t* mask, const Payloads& p, int* last, int k,
                  bool find_last, int m, int chunks, int window, int batch,
                  cudaStream_t s) {
  switch (k) {
    case 1:
      return launch_fill<G, 1>(mask, p, last, find_last, m, chunks, window,
                               batch, s);
    case 2:
      return launch_fill<G, 2>(mask, p, last, find_last, m, chunks, window,
                               batch, s);
    case 3:
      return launch_fill<G, 3>(mask, p, last, find_last, m, chunks, window,
                               batch, s);
    case 4:
      return launch_fill<G, 4>(mask, p, last, find_last, m, chunks, window,
                               batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// mask: (batch, m) uint8 (0/1); in0..in3 / out0..out3: (batch, m) int32,
// the first k used (1 <= k <= 4); all 16-byte aligned, m a multiple of
// 128. last: (batch, ceil(m / chunk)) int32, each chunk's latest set
// index: find_last 1 writes every entry first (last_set_kernel), 0 reads
// what an earlier call on the same mask and chunk wrote. chunk: 1024, 2048
// or 4096 positions. window: a position is filled only from a set mask
// less than `window` positions behind it.
SNK_EXPORT int snk_ffill(const void* mask, const void* in0, const void* in1,
                         const void* in2, const void* in3, void* out0,
                         void* out1, void* out2, void* out3, void* last,
                         int k, int find_last, int m, int chunk, int window,
                         int batch, void* stream) {
  Payloads p;
  p.in[0] = static_cast<const int32_t*>(in0);
  p.in[1] = static_cast<const int32_t*>(in1);
  p.in[2] = static_cast<const int32_t*>(in2);
  p.in[3] = static_cast<const int32_t*>(in3);
  p.out[0] = static_cast<int32_t*>(out0);
  p.out[1] = static_cast<int32_t*>(out1);
  p.out[2] = static_cast<int32_t*>(out2);
  p.out[3] = static_cast<int32_t*>(out3);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  int* lt = static_cast<int*>(last);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = (m + chunk - 1) / chunk;
  switch (chunk) {
    case kSpan:
      return launch_fill_k<1>(mk, p, lt, k, find_last != 0, m, chunks,
                              window, batch, s);
    case 2 * kSpan:
      return launch_fill_k<2>(mk, p, lt, k, find_last != 0, m, chunks,
                              window, batch, s);
    case 4 * kSpan:
      return launch_fill_k<4>(mk, p, lt, k, find_last != 0, m, chunks,
                              window, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
