// ffill: multi-payload forward fill from the latest set mask position.
//
// Replaces tpu_snappy/ops/pallas/ffill.py:ffill_block, which keeps a whole
// row in VMEM and runs log2(M) Hillis-Steele roll levels. That shape
// answers a chip without a vector gather; this card has one. So the fill
// is an index problem: last[i] = max over j <= i of (mask[j] ? j : -1), a
// max-scan, then out[i] = val[last[i]] (or val[i] where no mask precedes
// i). One block owns one row and walks it in 1024-wide chunks: a warp
// shuffle scan, a scan of the 32 warp totals, and a carry across chunks.
//
// Bound on this card: bytes and the serial chunk walk. Each payload is
// read and written once (plus the gather, which mostly hits one cached
// element); with one block per row the walk is latency-bound at small
// batch, which a later version can cut with a decoupled look-back scan.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;  // 32 warps: the warp-total scan fits one warp
constexpr int kMaxPayloads = 4;

struct Payloads {
  const int32_t* in[kMaxPayloads];
  int32_t* out[kMaxPayloads];
};

__global__ void __launch_bounds__(kThreads)
ffill_kernel(const uint8_t* __restrict__ mask, Payloads p, int k, int m) {
  __shared__ int warp_max[32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row = static_cast<size_t>(blockIdx.x) * m;
  int carry = -1;  // latest set index in earlier chunks
  for (int c0 = 0; c0 < m; c0 += kThreads) {
    const int i = c0 + tid;
    const int mine = (i < m && mask[row + i]) ? i : -1;
    const int incl = snk::warp_scan_max(mine);
    if (lane == 31) warp_max[warp] = incl;
    __syncthreads();
    if (warp == 0) warp_max[lane] = snk::warp_scan_max(warp_max[lane]);
    __syncthreads();
    const int before = warp > 0 ? warp_max[warp - 1] : -1;
    const int last = max(carry, max(before, incl));
    if (i < m) {
      const size_t from = row + (last >= 0 ? last : i);
#pragma unroll
      for (int j = 0; j < kMaxPayloads; ++j)
        if (j < k) p.out[j][row + i] = p.in[j][from];
    }
    carry = max(carry, warp_max[31]);
    __syncthreads();  // warp_max is rewritten by the next chunk
  }
}

}  // namespace

// mask: (batch, m) uint8 (0/1); in0..in3 / out0..out3: (batch, m) int32,
// the first k used (1 <= k <= 4).
SNK_EXPORT int snk_ffill(const void* mask, const void* in0, const void* in1,
                         const void* in2, const void* in3, void* out0,
                         void* out1, void* out2, void* out3, int k, int m,
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
  ffill_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), p, k, m);
  return static_cast<int>(cudaGetLastError());
}
