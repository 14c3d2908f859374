// emit: single-lane and two-lane emission of the encoder's committed parse.
//
// Replaces tpu_snappy/ops/pallas/emit.py:emit_block_single and emit_block,
// whose VMEM kernels run their three row-wide scans (the suffix-min of
// element starts, the exclusive cumsum of element sizes, the forward fill
// of the literal base) as 17 Hillis-Steele roll levels each over the whole
// row. Here one block owns one row and walks it in 1024-wide chunks with
// warp-shuffle scans and a carry between chunks, as csrc/ffill.cu does:
//   * walk 1, right to left: each position's run end (the next element
//     start, capped at n), kept as the literal run length in a scratch row;
//   * walk 2, left to right: element sizes, their exclusive cumsum (output
//     offsets), the literal base fill, the row's total and the packs.
//     Single lane: `pm` (the byte each position carries), the overflow
//     packs `pa`/`pb` (2nd/3rd literal header bytes, at run starts) and
//     `head` (a block-opening literal's tag); position i reads its
//     neighbours i-1, i-2 (copy header bytes) and i+1 (the next run's
//     tag). Two lanes: lane A (`pa`) the tag byte at an element start, the
//     2nd header byte of the element at i-1 or the 3rd of the one at i-2,
//     and lane B (`pb`) the literal payload; as in the XLA lanes, an idle
//     lane A still carries the low byte of t2[i-2] beside dest SENT.
//     The two previous output offsets come from shared memory across
//     chunk borders.
// Every pack is below 2^29, so int32 holds it.
//
// Bound on this card: bytes and the serial chunk walk. A position reads 9
// bytes (cj, off, its byte) and writes 12 (three packs; two lanes: 8),
// plus 8 of scratch;
// with one block per row the two walks are latency-bound, which a
// decoupled look-back scan over many blocks per row would cut.
#include "common.cuh"

namespace {

constexpr int kN = 1 << 16;
constexpr int kThreads = 1024;
constexpr int kHead = 128;
constexpr int kSentPack = (1 << 20) << 8;  // SENT << 8
constexpr int kCopy1MaxLen = 11;
constexpr int kCopy1MaxOffset = 2048;

// 0 <= c < 4, written as a bit test. Written as two compares, the
// optimiser turns it into (unsigned)c > 3 beside the copy test c > 3, and
// ptxas at -O3 (CUDA 12.8, sm_90a) then took the copy branch for c = -1;
// the bit test keeps the two conditions apart.
__device__ __forceinline__ bool lit_of(int c) { return (c & ~3) == 0; }

// Tag bytes are built in unsigned arithmetic (no shift of a negative int).
__device__ __forceinline__ uint32_t lit_tag(int len) {
  return len <= 60 ? static_cast<uint32_t>(len - 1) << 2
                   : (len <= 256 ? 60u << 2 : 61u << 2);
}

__device__ __forceinline__ uint32_t copy_tag(int len, int off, bool small) {
  const uint32_t l = static_cast<uint32_t>(len);
  return small ? 1u | (l - 4u) << 2 | (static_cast<uint32_t>(off) >> 8) << 5
               : 2u | (l - 1u) << 2;
}

__device__ __forceinline__ int lit_hdr(int len) {
  return len <= 60 ? 1 : (len <= 256 ? 2 : 3);
}

// Element start at a position whose committed jump is c, after one whose
// jump is cp (-1 where there is none).
__device__ __forceinline__ bool elem_of(int c, int cp) {
  return c >= 4 || (lit_of(c) && !lit_of(cp));
}

// kTwo: two-lane emission (pa = lane A, pb = lane B; pm and head unused).
template <bool kTwo>
__global__ void __launch_bounds__(kThreads)
emit_kernel(const int32_t* __restrict__ cj, const int32_t* __restrict__ off,
            const uint8_t* __restrict__ block,
            const int32_t* __restrict__ nlen, int32_t* __restrict__ lit_len,
            int32_t* __restrict__ pm, int32_t* __restrict__ pa,
            int32_t* __restrict__ pb, int32_t* __restrict__ head,
            int32_t* __restrict__ total) {
  __shared__ int wsc[32];             // per-warp scan totals
  __shared__ int oo[kThreads + 2];    // out_off of the chunk, 2 before it
  __shared__ int vs[kThreads];        // literal base at each run start
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t rb = static_cast<size_t>(blockIdx.x) * kN;
  const int n = nlen[blockIdx.x];

  // Walk 1: thread tid takes position c0 + 1023 - tid, so a scan over tid
  // runs right to left. run end = smallest element start > i, capped at n.
  int carry = kN;
  for (int c0 = kN - kThreads; c0 >= 0; c0 -= kThreads) {
    const int i = c0 + kThreads - 1 - tid;
    const int c = cj[rb + i];
    const bool prev_lit = i >= 1 && lit_of(cj[rb + i - 1]);
    const bool elem = c >= 4 || (lit_of(c) && !prev_lit);
    const int incl = snk::warp_scan_min(elem ? i : kN);
    if (lane == 31) wsc[warp] = incl;
    __syncthreads();
    if (warp == 0) wsc[lane] = snk::warp_scan_min(wsc[lane]);
    __syncthreads();
    int excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = kN;
    if (warp > 0) excl = min(excl, wsc[warp - 1]);
    excl = min(excl, carry);
    lit_len[rb + i] = max(min(excl, n) - i, 1);
    carry = min(carry, wsc[31]);
    __syncthreads();  // wsc is rewritten by the next chunk
  }
  // lit_len is read across threads below; make walk 1's writes visible.
  __threadfence_block();
  __syncthreads();

  // Walk 2, left to right.
  int carry_sum = 0;    // output bytes of earlier chunks
  int carry_last = -1;  // latest run start in earlier chunks
  int carry_v = 0;      // its literal base
  if (tid < 2) oo[tid] = 0;
  for (int c0 = 0; c0 < kN; c0 += kThreads) {
    const int i = c0 + tid;
    const int c = cj[rb + i];
    const int o = off[rb + i];
    const int cm1 = i >= 1 ? cj[rb + i - 1] : -1;
    const bool is_copy = c >= 4;
    const bool is_lit = lit_of(c);
    const bool lit_start = is_lit && !lit_of(cm1);
    const bool elem = is_copy || lit_start;
    const int ll = lit_len[rb + i];
    const bool small = c <= kCopy1MaxLen && o < kCopy1MaxOffset;
    const int lhdr = lit_hdr(ll);
    const int esz = elem ? (is_copy ? (small ? 2 : 3) : lhdr + ll) : 0;

    // Exclusive cumsum of element sizes: the output offset.
    int incl = snk::warp_scan_sum(esz);
    if (lane == 31) wsc[warp] = incl;
    __syncthreads();
    if (warp == 0) wsc[lane] = snk::warp_scan_sum(wsc[lane]);
    __syncthreads();
    incl += (warp > 0 ? wsc[warp - 1] : 0) + carry_sum;
    const int chunk_sum = wsc[31];
    const int out_off = incl - esz;
    oo[2 + tid] = out_off;
    vs[tid] = out_off + lhdr - i;
    __syncthreads();

    // Literal base: from the latest run start <= i (own value before any).
    int last = snk::warp_scan_max(lit_start ? i : -1);
    if (lane == 31) wsc[warp] = last;
    __syncthreads();
    if (warp == 0) wsc[lane] = snk::warp_scan_max(wsc[lane]);
    __syncthreads();
    if (warp > 0) last = max(last, wsc[warp - 1]);
    const int chunk_last = wsc[31];
    const int v = last >= c0 ? vs[last - c0]
                  : (carry_last >= 0 ? carry_v : out_off + lhdr - i);

    // The byte this position carries.
    const int cm2 = i >= 2 ? cj[rb + i - 2] : -1;
    const int om1 = i >= 1 ? off[rb + i - 1] : 0;
    const int om2 = i >= 2 ? off[rb + i - 2] : 0;
    if constexpr (kTwo) {
      // Lane A: the element at i (its tag), else the 2nd header byte of
      // the element at i-1, else the 3rd of the one at i-2.
      const int cm3 = i >= 3 ? cj[rb + i - 3] : -1;
      const bool e1 = i >= 1 && elem_of(cm1, cm2);
      const bool e2 = i >= 2 && elem_of(cm2, cm3);
      const int ll1 = i >= 1 ? lit_len[rb + i - 1] : 1;
      const int ll2 = i >= 2 ? lit_len[rb + i - 2] : 1;
      const bool small1 = cm1 <= kCopy1MaxLen && om1 < kCopy1MaxOffset;
      const bool small2 = cm2 <= kCopy1MaxLen && om2 < kCopy1MaxOffset;
      const int hdr1 = cm1 >= 4 ? (small1 ? 2 : 3) : lit_hdr(ll1);
      const int hdr2 = cm2 >= 4 ? (small2 ? 2 : 3) : lit_hdr(ll2);
      const uint32_t t1 = static_cast<uint32_t>(cm1 >= 4 ? om1 : ll1 - 1);
      const uint32_t t2 =
          i >= 2 ? static_cast<uint32_t>(cm2 >= 4 ? om2 : ll2 - 1) >> 8 : 0u;
      uint32_t ad, av;
      if (elem) {
        ad = out_off;
        av = is_copy ? copy_tag(c, o, small) : lit_tag(ll);
      } else if (e1 && hdr1 >= 2) {
        ad = oo[2 + tid - 1] + 1;
        av = t1;
      } else {
        ad = e2 && hdr2 >= 3 ? oo[2 + tid - 2] + 2 : 1u << 20;
        av = t2;
      }
      pa[rb + i] = static_cast<int32_t>(ad << 8 | (av & 0xFFu));
      const uint32_t bd = is_lit ? static_cast<uint32_t>(v + i) : 1u << 20;
      pb[rb + i] = static_cast<int32_t>(bd << 8 | block[rb + i]);
    } else {
      const bool c1 = cm1 >= 4;  // 2nd header byte of the copy at i-1
      const bool c2v = cm2 >= 4  // 3rd header byte of a 3-byte copy at i-2
                       && !(cm2 <= kCopy1MaxLen && om2 < kCopy1MaxOffset);
      const bool lt0c = i + 1 < kN && !is_lit && lit_of(cj[rb + i + 1]);
      uint32_t md, mv;
      if (is_lit) {
        md = v + i;
        mv = block[rb + i];
      } else if (is_copy) {
        md = out_off;
        mv = copy_tag(c, o, small);
      } else if (c1) {
        md = oo[2 + tid - 1] + 1;
        mv = om1;
      } else if (c2v) {
        md = oo[2 + tid - 2] + 2;
        mv = om2 >> 8;
      } else if (lt0c) {
        md = incl;  // out_off[i + 1]
        mv = lit_tag(lit_len[rb + i + 1]);
      } else {
        md = 1u << 20;
        mv = 0;
      }
      pm[rb + i] = static_cast<int32_t>(md << 8 | (mv & 0xFFu));
      const uint32_t n1 = ll - 1;
      const uint32_t oo32 = out_off;
      pa[rb + i] = lit_start && lhdr == 3
          ? static_cast<int32_t>((oo32 + 2) << 8 | (n1 >> 8 & 0xFFu)) : 0;
      pb[rb + i] = lit_start && lhdr >= 2
          ? static_cast<int32_t>((oo32 + 1) << 8 | (n1 & 0xFFu)) : 0;
      if (c0 == 0 && tid < kHead)
        head[static_cast<size_t>(blockIdx.x) * kHead + tid] =
            tid == 0 && lit_start ? static_cast<int32_t>(lit_tag(ll) & 0xFFu)
                                  : kSentPack;
    }

    // Carries into the next chunk.
    carry_sum += chunk_sum;
    if (chunk_last >= 0) {
      carry_v = vs[chunk_last - c0];
      carry_last = chunk_last;
    }
    __syncthreads();  // oo, vs and wsc are rewritten by the next chunk
    if (tid >= kThreads - 2) oo[tid - (kThreads - 2)] = out_off;
  }
  if (tid == 0) total[blockIdx.x] = carry_sum;
}

}  // namespace

// cj: (batch, 65536) int32, committed ? jump : -1; off: (batch, 65536)
// int32; block: (batch, 65536) uint8; n: (batch,) int32; lit_len: (batch,
// 65536) int32 scratch; pm, pa, pb: (batch, 65536) int32; head: (batch,
// 128) int32; total: (batch,) int32.
SNK_EXPORT int snk_emit_single(const void* cj, const void* off,
                               const void* block, const void* n,
                               void* lit_len, void* pm, void* pa, void* pb,
                               void* head, void* total, int batch,
                               void* stream) {
  emit_kernel<false>
      <<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cj), static_cast<const int32_t*>(off),
      static_cast<const uint8_t*>(block), static_cast<const int32_t*>(n),
      static_cast<int32_t*>(lit_len), static_cast<int32_t*>(pm),
      static_cast<int32_t*>(pa), static_cast<int32_t*>(pb),
      static_cast<int32_t*>(head), static_cast<int32_t*>(total));
  return static_cast<int>(cudaGetLastError());
}

// Two-lane form: cj, off, block, n and the lit_len scratch as above;
// pack_a, pack_b: (batch, 65536) int32; total: (batch,) int32.
SNK_EXPORT int snk_emit_two_lane(const void* cj, const void* off,
                                 const void* block, const void* n,
                                 void* lit_len, void* pack_a, void* pack_b,
                                 void* total, int batch, void* stream) {
  emit_kernel<true>
      <<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int32_t*>(cj), static_cast<const int32_t*>(off),
          static_cast<const uint8_t*>(block), static_cast<const int32_t*>(n),
          static_cast<int32_t*>(lit_len), nullptr,
          static_cast<int32_t*>(pack_a), static_cast<int32_t*>(pack_b),
          nullptr, static_cast<int32_t*>(total));
  return static_cast<int>(cudaGetLastError());
}
