// emit: single-lane and two-lane emission of the encoder's committed parse.
//
// Replaces tpu_snappy/ops/pallas/emit.py:emit_block_single and emit_block,
// whose VMEM kernels run their three row-wide scans (the suffix-min of
// element starts, the exclusive cumsum of element sizes, the forward fill
// of the literal base) as 17 Hillis-Steele roll levels each over the whole
// row. What every position needs:
//   * its run end (the next element start, capped at n), so its literal
//     run length;
//   * element sizes and their exclusive cumsum (output offsets), the
//     literal base filled forward from each run start, the row's total;
//   * single lane: `pm` (the byte each position carries), the overflow
//     packs `pa`/`pb` (2nd/3rd literal header bytes, at run starts) and
//     `head` (a block-opening literal's tag); position i reads its
//     neighbours i-1, i-2 (copy header bytes) and i+1 (the next run's
//     tag). Two lanes: lane A (`pa`) the tag byte at an element start, the
//     2nd header byte of the element at i-1 or the 3rd of the one at i-2,
//     and lane B (`pb`) the literal payload; as in the XLA lanes, an idle
//     lane A still carries the low byte of t2[i-2] beside dest SENT.
// Every pack is below 2^29, so int32 holds it.
//
// Bound on this card: bytes. A position reads 9 bytes (cj, off, its byte)
// and writes 12 (three packs; two lanes: 8). One block walking a whole row
// is latency-bound (128 blocks at B = 128, each a chain of dependent chunk
// steps), so a row is cut into tiles of kTile = 2048 positions
// (emit.py:TILE; 4096 blocks at B = 128), and the row-wide scans become
// a tile summary and a decoupled look-back:
//   1. summary_kernel: each tile's first element start and its first start
//      after the tile's first position (an early-exit scan: usually one
//      chunk), into a (batch, kTiles) int2 scratch; it also resets the
//      tile's look-back status word and the ticket counter, so nothing
//      needs a memset.
//   2. emit_kernel: a block takes its (row, tile) from a ticket counter,
//      ticket k being tile k / batch of row k % batch: a tile starts only
//      after every earlier tile of its row (a look-back never waits on a
//      block that has not started), and a batch of tickets after it, so
//      a row's tiles are staggered and their look-backs rarely wait.
//      Each thread holds 8 consecutive positions in registers (16-byte
//      loads) plus the two before and the one after
//      (header bytes and element starts straddle threads and tiles). Run
//      ends are an in-tile suffix-min plus the minimum of the later tiles'
//      first starts (from the summary, in L2); then the element sizes,
//      their in-tile exclusive sum and the latest run start with its
//      tile-relative base. The thread holding the tile's last run start
//      publishes (sum, base) as the tile's aggregate as soon as it has
//      them; warp 0 reads the predecessors' status words, one a lane,
//      nearest first, up to an inclusive prefix, which gives the tile's
//      output offset and the literal-base carry, and publishes the tile's
//      own inclusive prefix. Then every pack is written once, with 16-byte
//      stores; tile 0 writes `head`, the last tile `total`.
// No row-sized scratch: the earlier one-block-a-row walk wrote and re-read
// a (batch, 65536) run-length row (8 bytes a position). On the card the
// latency of the loads and three scans before a tile's aggregate, more
// than the bytes, bounds this form (PERF.md, section 6).
#include "common.cuh"

namespace {

constexpr int kN = 1 << 16;
constexpr int kPer = 8;  // consecutive positions a thread
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kPer * kThreads;
constexpr int kTiles = kN / kTile;
static_assert(kTiles <= 32, "a warp reads every predecessor, one a lane");
constexpr int kSummaryThreads = 128;
constexpr int kHead = 128;
constexpr int kSent = 1 << 20;
constexpr int kSentPack = kSent << 8;  // SENT << 8
constexpr int kCopy1MaxLen = 11;
constexpr int kCopy1MaxOffset = 2048;
constexpr unsigned kFull = 0xffffffffu;


// Look-back status word: flag in bits 62-63 (0 none yet, 1 aggregate, 2
// inclusive prefix), the sum or inclusive prefix in the low 32 bits, and
// in bits 32-61 a literal base + kBias (0: no run start so far).
constexpr uint32_t kAggregate = 1u;
constexpr uint32_t kPrefix = 2u;
constexpr int kBias = 1 << 24;

// Scratch, laid out by the wrapper (emit.py:scratch_ints): status words
// (batch, kTiles) u64, then the summary (batch, kTiles) int2 (first
// element start >= the tile's first position, first start after it; N
// where none), then the ticket counter.
struct Scratch {
  unsigned long long* status;
  int2* first;
  int* ticket;
};

Scratch scratch_of(void* base, int batch) {
  int* p = static_cast<int*>(base);
  return {reinterpret_cast<unsigned long long*>(p),
          reinterpret_cast<int2*>(p + 2 * batch * kTiles),
          p + 4 * batch * kTiles};
}

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

__device__ __forceinline__ bool small_copy(int c, int o) {
  return c <= kCopy1MaxLen && o < kCopy1MaxOffset;
}

// Element start at a position whose committed jump is c, after one whose
// jump is cp (-1 where there is none).
__device__ __forceinline__ bool elem_of(int c, int cp) {
  return c >= 4 || (lit_of(c) && !lit_of(cp));
}

__device__ __forceinline__ void publish(unsigned long long* at,
                                        uint32_t flag, int value, bool has,
                                        int base) {
  const uint32_t hi =
      flag << 30 | (has ? static_cast<uint32_t>(base + kBias) : 0u);
  const unsigned long long w =
      static_cast<unsigned long long>(hi) << 32 | static_cast<uint32_t>(value);
  *reinterpret_cast<volatile unsigned long long*>(at) = w;
}

// Grid (kTiles, batch). Chunks of 512 positions, four a thread, until the
// first element start after the tile's first position.
__global__ void __launch_bounds__(kSummaryThreads)
summary_kernel(const int32_t* __restrict__ cj, Scratch sc) {
  __shared__ int wmin[kSummaryThreads / 32];
  const int row = blockIdx.y;
  const int tile = blockIdx.x;
  const int t0 = tile * kTile;
  const int32_t* r = cj + static_cast<size_t>(row) * kN;
  const int lane = threadIdx.x & 31;
  int after = kN;
  for (int c0 = t0; c0 < t0 + kTile; c0 += 4 * kSummaryThreads) {
    const int i = c0 + 4 * threadIdx.x;
    const int4 c = __ldg(reinterpret_cast<const int4*>(r + i));
    const int cp = i ? __ldg(r + i - 1) : -1;
    int f = kN;
    if (elem_of(c.w, c.z)) f = i + 3;
    if (elem_of(c.z, c.y)) f = i + 2;
    if (elem_of(c.y, c.x)) f = i + 1;
    if (i > t0 && elem_of(c.x, cp)) f = i;
    f = __reduce_min_sync(kFull, f);
    if (lane == 0) wmin[threadIdx.x >> 5] = f;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kSummaryThreads / 32; ++w) f = min(f, wmin[w]);
    __syncthreads();
    if (f < kN) {
      after = f;
      break;
    }
  }
  if (threadIdx.x == 0) {
    const bool start0 = elem_of(r[t0], t0 ? r[t0 - 1] : -1);
    const int at = row * kTiles + tile;
    sc.first[at] = make_int2(start0 ? t0 : after, after);
    sc.status[at] = 0ull;
    if (tile == 0 && row == 0) sc.ticket[0] = 0;
  }
}

// kTwo: two-lane emission (pa = lane A, pb = lane B; pm and head unused).
// Grid (kTiles, batch); the row and tile come from the ticket.
template <bool kTwo>
__global__ void __launch_bounds__(kThreads, 4)
emit_kernel(const int32_t* __restrict__ cj, const int32_t* __restrict__ off,
            const uint8_t* __restrict__ block,
            const int32_t* __restrict__ nlen, Scratch sc,
            int32_t* __restrict__ pm, int32_t* __restrict__ pa,
            int32_t* __restrict__ pb, int32_t* __restrict__ head,
            int32_t* __restrict__ total) {
  __shared__ int s_tile, s_after, s_prefix, s_carry;
  __shared__ int wred[kWarps], wsum[kWarps], wlast[kWarps];
  __shared__ int llf[kThreads + 1];  // lit_len of each thread's first
  __shared__ int vs[kTile];          // tile-relative base at run starts
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(sc.ticket, 1);
  __syncthreads();
  const int row = s_tile % gridDim.y;
  const int tile = s_tile / gridDim.y;
  const size_t rb = static_cast<size_t>(row) * kN;
  const int t0 = tile * kTile;
  const int n = nlen[row];

  // Warp 0: the later tiles' first starts, and lit_len of the next tile's
  // first position (read only where a run starts there).
  if (warp == 0) {
    const int j = tile + 1 + lane;
    const int2 fs = j < kTiles ? sc.first[row * kTiles + j]
                               : make_int2(kN, kN);
    const int after = __reduce_min_sync(kFull, fs.x);
    const int after2 = __reduce_min_sync(kFull, lane ? fs.x : fs.y);
    if (lane == 0) {
      s_after = after;
      llf[kThreads] = max(min(after2, n) - (t0 + kTile), 1);
    }
  }

  // Positions i0 - 3 .. i0 + kPer: C[k + 3] is cj at i0 + k (-1 outside
  // the row), O[k + 2] off at i0 + k (0 before the row).
  const int i0 = t0 + kPer * tid;
  int C[kPer + 4], O[kPer + 2];
  {
    const int4* cp = reinterpret_cast<const int4*>(cj + rb + i0);
    const int4* op = reinterpret_cast<const int4*>(off + rb + i0);
#pragma unroll
    for (int u = 0; u < kPer / 4; ++u) {
      const int4 c = __ldg(cp + u), o = __ldg(op + u);
      C[3 + 4 * u] = c.x; C[4 + 4 * u] = c.y;
      C[5 + 4 * u] = c.z; C[6 + 4 * u] = c.w;
      O[2 + 4 * u] = o.x; O[3 + 4 * u] = o.y;
      O[4 + 4 * u] = o.z; O[5 + 4 * u] = o.w;
    }
#pragma unroll
    for (int k = -3; k < 0; ++k)
      C[k + 3] = i0 + k >= 0 ? __ldg(cj + rb + i0 + k) : -1;
#pragma unroll
    for (int k = -2; k < 0; ++k)
      O[k + 2] = i0 + k >= 0 ? __ldg(off + rb + i0 + k) : 0;
    C[kPer + 3] = i0 + kPer < kN ? __ldg(cj + rb + i0 + kPer) : -1;
  }
  const uint2 b8 = __ldg(reinterpret_cast<const uint2*>(block + rb + i0));
  const uint32_t bytes[2] = {b8.x, b8.y};
  auto lit = [&](int k) { return lit_of(C[k + 3]); };
  auto elem = [&](int k) { return elem_of(C[k + 3], C[k + 2]); };
  auto lit_start = [&](int k) { return lit(k) && !lit(k - 1); };

  // Run ends: the first element start after each position.
  int fe = kN;
#pragma unroll
  for (int k = kPer - 1; k >= 0; --k)
    if (elem(k)) fe = i0 + k;
  int run = fe;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_down_sync(kFull, run, d);
    if (lane + d < 32) run = min(run, o);
  }
  if (lane == 0) wred[warp] = run;
  __syncthreads();
  {
    const int nxt = __shfl_down_sync(kFull, run, 1);
    run = lane < 31 ? nxt : kN;
  }
  run = min(run, s_after);
#pragma unroll
  for (int w = 1; w < kWarps; ++w)  // independent loads, no chain
    if (w > warp) run = min(run, wred[w]);
  // LL[k + 2]: lit_len at i0 + k, k = -2 .. kPer - 1.
  int LL[kPer + 2];
#pragma unroll
  for (int k = kPer - 1; k >= -2; --k) {
    LL[k + 2] = max(min(run, n) - (i0 + k), 1);
    if (elem(k)) run = i0 + k;
  }
  llf[tid] = LL[2];

  // Element sizes and literal header sizes at i0 - 2 .. i0 + kPer - 1,
  // and output offsets at i0 - 2 .. i0 + kPer relative to i0's.
  int ES[kPer + 2], LH[kPer + 2], OO[kPer + 3];
#pragma unroll
  for (int k = -2; k < kPer; ++k) {
    const int c = C[k + 3];
    LH[k + 2] = lit_hdr(LL[k + 2]);
    const int sz = c >= 4 ? (small_copy(c, O[k + 2]) ? 2 : 3)
                          : LH[k + 2] + LL[k + 2];
    ES[k + 2] = elem(k) ? sz : 0;
  }
  OO[2] = 0;
  OO[1] = -ES[1];
  OO[0] = OO[1] - ES[0];
#pragma unroll
  for (int k = 1; k <= kPer; ++k) OO[k + 2] = OO[k + 1] + ES[k + 1];

  // Element sizes' in-tile exclusive sum and the latest run start.
  const int sum = OO[kPer + 2];
  int mine_last = -1;
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (lit_start(k)) mine_last = i0 + k;
  int incl_s = snk::warp_scan_sum(sum);
  int incl_l = snk::warp_scan_max(mine_last);
  if (lane == 31) {
    wsum[warp] = incl_s;
    wlast[warp] = incl_l;
  }
  __syncthreads();
  int excl = incl_s - sum;
  int prev_last = __shfl_up_sync(kFull, incl_l, 1);
  if (lane == 0) prev_last = -1;
#pragma unroll
  for (int w = 0; w < kWarps - 1; ++w) {
    if (w < warp) {
      excl += wsum[w];
      prev_last = max(prev_last, wlast[w]);
    }
  }
  // Tile-relative literal base at my run starts (shared), and at my last.
  int my_rel = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (lit_start(k)) {
      my_rel = excl + OO[k + 2] + LH[k + 2] - (i0 + k);
      vs[i0 + k - t0] = my_rel;
    }
  }
  // The tile's aggregate goes out now, before the packs, so that later
  // tiles' look-backs find it: from the thread holding the tile's last run
  // start (thread 0 where there is none). Tile 0's is its prefix.
  if (mine_last >= 0 || tid == 0) {
    int tile_last = -1, tile_sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      tile_last = max(tile_last, wlast[w]);
      tile_sum += wsum[w];
    }
    if (tile_last >= 0 ? mine_last == tile_last : tid == 0)
      publish(sc.status + row * kTiles + tile, tile ? kAggregate : kPrefix,
              tile_sum, tile_last >= 0, my_rel);
  }
  __syncthreads();

  // Warp 0: the look-back, then the tile's inclusive prefix.
  if (warp == 0) {
    int tile_sum = 0, tile_last = -1;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      tile_sum += wsum[w];
      tile_last = max(tile_last, wlast[w]);
    }
    const bool has = tile_last >= 0;
    const int rel = has ? vs[tile_last - t0] : 0;
    unsigned long long* status = sc.status + row * kTiles;
    int prefix = 0, carry = 0;
    bool carry_has = false;
    if (tile > 0) {
      // One predecessor a lane, nearest first (a row has at most 32
      // tiles; before tile 0 a virtual inclusive prefix (0, none)), until
      // the nearest inclusive prefix.
      const int j = tile - 1 - lane;
      uint32_t flag = kPrefix, f1 = 0, f2 = 0;
      if (j >= 0) {
        unsigned long long w;
        long spins = 0;
        do {
          w = *reinterpret_cast<volatile unsigned long long*>(status + j);
          // Every earlier tile has started (tickets), so its aggregate
          // comes; a broken status word traps instead of hanging.
          if (++spins > (1l << 26)) __trap();
        } while ((w >> 62) == 0);
        flag = static_cast<uint32_t>(w >> 62);
        f1 = static_cast<uint32_t>(w);
        f2 = static_cast<uint32_t>(w >> 32) & 0x3FFFFFFFu;
      }
      const int lp = __ffs(__ballot_sync(kFull, flag == kPrefix)) - 1;
      const int upto = snk::warp_scan_sum(lane < lp ? static_cast<int>(f1)
                                                    : 0);
      prefix = __shfl_sync(kFull, static_cast<int>(f1), lp) +
               __shfl_sync(kFull, upto, 31);
      const unsigned hm = __ballot_sync(kFull, lane <= lp && f2 != 0);
      if (hm) {
        const int lh = __ffs(hm) - 1;
        const int base = __shfl_sync(kFull, static_cast<int>(f2) - kBias, lh);
        const int up = __shfl_sync(kFull, upto, lh);
        // An aggregate's base is relative to its tile's own offset: the
        // tile's prefix less the sums from it up to this one.
        carry = lh < lp ? base + prefix - up : base;
        carry_has = true;
      }
    }
    if (lane == 0) {
      if (tile > 0)
        publish(status + tile, kPrefix, prefix + tile_sum, has || carry_has,
                has ? rel + prefix : carry);
      s_prefix = prefix;
      s_carry = carry;
      if (tile == kTiles - 1) total[row] = prefix + tile_sum;
    }
  }
  __syncthreads();
  // The packs, branch-free: every candidate computed, then selected in
  // rising priority. out_off at i0 + k is off0 + OO[k + 2].
  const int off0 = s_prefix + excl;
  // The literal base of my positions' run: from the latest run start
  // before my positions (in the tile, shared; else the earlier tiles'
  // carry) until my own first. A literal always has a run start at or
  // before it.
  int base = prev_last >= t0 ? s_prefix + vs[prev_last - t0] : s_carry;
  const int ll_next = llf[tid + 1];
  uint32_t ra[kPer], rb2[kPer], rc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = i0 + k;
    const int c = C[k + 3];
    const int o = O[k + 2];
    const int cm1 = C[k + 2], cm2 = C[k + 1];
    const int om1 = O[k + 1], om2 = O[k];
    const bool is_copy = c >= 4;
    const bool is_lit = lit(k);
    const bool ls = lit_start(k);
    const int ll = LL[k + 2];
    const int lhdr = LH[k + 2];
    const uint32_t out_off = off0 + OO[k + 2];
    const uint32_t ct = copy_tag(c, o, small_copy(c, o));
    base = ls ? static_cast<int>(out_off) + lhdr - i : base;
    const uint32_t lit_dest = static_cast<uint32_t>(base + i);
    const uint32_t byte = bytes[k / 4] >> (8 * (k % 4)) & 0xFFu;
    if constexpr (kTwo) {
      const bool e1 = i >= 1 && elem(k - 1);
      const bool e2 = i >= 2 && elem(k - 2);
      const int ll1 = i >= 1 ? LL[k + 1] : 1;
      const int ll2 = i >= 2 ? LL[k] : 1;
      const int hdr1 = cm1 >= 4 ? (small_copy(cm1, om1) ? 2 : 3)
                                : (i >= 1 ? LH[k + 1] : 1);
      const int hdr2 = cm2 >= 4 ? (small_copy(cm2, om2) ? 2 : 3)
                                : (i >= 2 ? LH[k] : 1);
      const uint32_t t1 = static_cast<uint32_t>(cm1 >= 4 ? om1 : ll1 - 1);
      const uint32_t t2 =
          i >= 2 ? static_cast<uint32_t>(cm2 >= 4 ? om2 : ll2 - 1) >> 8 : 0u;
      const bool a2 = e2 && hdr2 >= 3;
      const bool a1 = e1 && hdr1 >= 2;
      const bool el = elem(k);
      uint32_t ad = a2 ? off0 + OO[k] + 2 : static_cast<uint32_t>(kSent);
      uint32_t av = t2;
      ad = a1 ? off0 + OO[k + 1] + 1 : ad;
      av = a1 ? t1 : av;
      ad = el ? out_off : ad;
      av = el ? (is_copy ? ct : lit_tag(ll)) : av;
      ra[k] = ad << 8 | (av & 0xFFu);
      rb2[k] = (is_lit ? lit_dest : static_cast<uint32_t>(kSent)) << 8 | byte;
    } else {
      const bool c1 = cm1 >= 4;  // 2nd header byte of the copy at i-1
      const bool c2v = cm2 >= 4 && !small_copy(cm2, om2);  // 3rd, i-2
      const bool lt0c = i + 1 < kN && !is_lit && lit(k + 1);
      // lit_len of the run starting at i + 1 (the next thread's first).
      const int lln = k + 1 < kPer ? LL[k + 3] : ll_next;
      uint32_t md = lt0c ? off0 + OO[k + 3] : static_cast<uint32_t>(kSent);
      uint32_t mv = lt0c ? lit_tag(lln) : 0u;
      md = c2v ? off0 + OO[k] + 2 : md;
      mv = c2v ? static_cast<uint32_t>(om2) >> 8 : mv;
      md = c1 ? off0 + OO[k + 1] + 1 : md;
      mv = c1 ? static_cast<uint32_t>(om1) : mv;
      md = is_copy ? out_off : md;
      mv = is_copy ? ct : mv;
      md = is_lit ? lit_dest : md;
      mv = is_lit ? byte : mv;
      rc[k] = md << 8 | (mv & 0xFFu);
      const uint32_t n1 = ll - 1;
      ra[k] = ls && lhdr == 3 ? (out_off + 2) << 8 | (n1 >> 8 & 0xFFu) : 0u;
      rb2[k] = ls && lhdr >= 2 ? (out_off + 1) << 8 | (n1 & 0xFFu) : 0u;
    }
  }
  auto store = [&](int32_t* dst, const uint32_t* v) {
    int4* q = reinterpret_cast<int4*>(dst + rb + i0);
#pragma unroll
    for (int u = 0; u < kPer / 4; ++u)
      q[u] = make_int4(v[4 * u], v[4 * u + 1], v[4 * u + 2], v[4 * u + 3]);
  };
  store(pa, ra);
  store(pb, rb2);
  if constexpr (!kTwo) {
    store(pm, rc);
    if (tile == 0 && tid < kHead)
      head[static_cast<size_t>(row) * kHead + tid] =
          tid == 0 && lit_start(0)
              ? static_cast<int32_t>(lit_tag(LL[2]) & 0xFFu)
              : kSentPack;
  }
}

template <bool kTwo>
int launch(const void* cj, const void* off, const void* block, const void* n,
           void* scratch, void* pm, void* pa, void* pb, void* head,
           void* total, int batch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Scratch sc = scratch_of(scratch, batch);
  const auto* c = static_cast<const int32_t*>(cj);
  const dim3 grid(kTiles, batch);
  summary_kernel<<<grid, kSummaryThreads, 0, s>>>(c, sc);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  emit_kernel<kTwo><<<grid, kThreads, 0, s>>>(
      c, static_cast<const int32_t*>(off), static_cast<const uint8_t*>(block),
      static_cast<const int32_t*>(n), sc, static_cast<int32_t*>(pm),
      static_cast<int32_t*>(pa), static_cast<int32_t*>(pb),
      static_cast<int32_t*>(head), static_cast<int32_t*>(total));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cj: (batch, 65536) int32, committed ? jump : -1; off: (batch, 65536)
// int32; block: (batch, 65536) uint8; n: (batch,) int32; scratch: 4 x
// 32 x batch + 1 int32 (emit.py:scratch_ints), overwritten; pm, pa, pb:
// (batch, 65536) int32; head: (batch, 128) int32; total: (batch,) int32.
SNK_EXPORT int snk_emit_single(const void* cj, const void* off,
                               const void* block, const void* n,
                               void* scratch, void* pm, void* pa, void* pb,
                               void* head, void* total, int batch,
                               void* stream) {
  return launch<false>(cj, off, block, n, scratch, pm, pa, pb, head, total,
                       batch, stream);
}

// Two-lane form: cj, off, block, n and scratch as above; pack_a, pack_b:
// (batch, 65536) int32; total: (batch,) int32.
SNK_EXPORT int snk_emit_two_lane(const void* cj, const void* off,
                                 const void* block, const void* n,
                                 void* scratch, void* pack_a, void* pack_b,
                                 void* total, int batch, void* stream) {
  return launch<true>(cj, off, block, n, scratch, nullptr, pack_a, pack_b,
                      nullptr, total, batch, stream);
}
