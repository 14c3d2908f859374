// gather_block: y[b, t] = x[b, idx[b, t]], kept to the low 8 * limbs bits;
// 0 where idx lies outside [0, S).
//
// Replaces tpu_snappy/ops/pallas/gather.py:gather_block. The TPU has no
// vector gather, so its kernel splits each index into a 256-row one-hot
// (a row gather on the MXU over pre-scaled 8-bit limb tables, resident in
// VMEM) and a 256-lane one-hot select; `limbs` is the value width that
// decomposition keeps exact, and a value wider than 8 * limbs bits loses
// its high limbs, which this kernel reproduces with a mask. Hopper has an
// indexed load, so a thread reads its targets straight from the table: no
// one-hot, no limb tables.
//
// Bound on this card: bytes. The decoder's dense rounds gather 128 rows of
// 65536 int32 pointers from tables of the same size (x and idx one
// tensor), the chase 12288 a row from them, the sidecar and the final
// byte gathers 65536 a row from tables of bytes. Each target reads its
// index, one random table word and writes one word. The random reads cost
// the table a 32-byte sector each, but the grid runs its rows nearly in
// order, so the tables of the rows in flight (a few MB) stay in the 50 MB
// L2, and every table is read from device memory about once, as the bound
// counts it. What limits the kernel is loads in flight: each thread serves
// four targets, one 16-byte index load and four independent table loads,
// then one 16-byte store.
//
// A table staged in shared memory, packed to the limbs (the TPU kernel's
// resident table), was measured against this kernel on every main-path
// shape and lost on each: staging reads the same bytes from device memory
// that L2 already saves here, and with one 128 KB table a block (limbs 2)
// a block cannot overlap its reads with its writes (PERF.md, section 6).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 4;  // targets a thread: 4 table loads in flight

// Grid (ceil(ceil(t / 4) / kThreads), batch): thread i serves targets
// 4i .. 4i+3 of its row, with 16-byte index loads and stores where t is a
// multiple of 4 (the wrapper checks that every pointer is 16-byte aligned),
// one by one otherwise.
__global__ void __launch_bounds__(kThreads)
gather_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ idx,
              int32_t* __restrict__ y, int s, int t, uint32_t mask) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const size_t row = blockIdx.y;
  const int32_t* xr = x + row * s;
  if ((t & 3) == 0) {
    if (i >= t / kPerThread) return;
    const size_t o = row * (t / kPerThread) + i;
    const int4 j = __ldg(reinterpret_cast<const int4*>(idx) + o);
    reinterpret_cast<int4*>(y)[o] =
        make_int4(snk::take(xr, s, j.x, mask), snk::take(xr, s, j.y, mask),
                  snk::take(xr, s, j.z, mask), snk::take(xr, s, j.w, mask));
    return;
  }
  for (int k = kPerThread * i; k < min(t, kPerThread * (i + 1)); ++k) {
    const size_t o = row * t + k;
    y[o] = snk::take(xr, s, __ldg(idx + o), mask);
  }
}

}  // namespace

// x: (batch, s) int32 table; idx, y: (batch, t) int32, all 16-byte
// aligned; 1 <= limbs <= 3.
SNK_EXPORT int snk_gather(const void* x, const void* idx, void* y, int s,
                          int t, int limbs, int batch, void* stream) {
  const uint32_t mask = (1u << (8 * limbs)) - 1u;
  const int threads = (t + kPerThread - 1) / kPerThread;
  dim3 grid((threads + kThreads - 1) / kThreads, batch);
  gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(idx),
      static_cast<int32_t*>(y), s, t, mask);
  return static_cast<int>(cudaGetLastError());
}
