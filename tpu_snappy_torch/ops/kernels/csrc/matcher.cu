// matcher: the fused encoder matcher, on the packed or the unpacked
// candidate table.
//
// Replaces tpu_snappy/ops/pallas/matcher.py:matcher_block_packed and
// matcher_block (sticky "exact" and "sig", any K >= 2: matcher_kernel<K>
// for K 2-24, matcher_wide_kernel above; see "The wide form"). The TPU
// kernel holds a whole 64K row in VMEM and runs every stage as full-row
// Hillis-Steele rolls. What it computes, and what this kernel keeps bit
// for bit:
//   * sticky offsets: 4 levels of the windowed keep-set composition at
//     shifts 4, 8, 16, 32; below gidx = s a level is the identity. At
//     "exact" membership compares with each of the K keeps; at "sig" it
//     is one AND with the u32 mask of the keeps' hash buckets (bit
//     (x * 0x9E3779B1) >> 27 of each keep > 0), and the composed default
//     is then re-verified exactly against the position's ORIGINAL table,
//     falling back to its original column 0 (a bucket collision can carry
//     a non-member through the levels);
//   * match lengths: stride-4 links counted by 4 capped doubling rounds
//     (= the number of consecutive links, at most 16), mlq = 4 + 4r, the
//     max over phases p = 1..3, then min(ml, n - i); the TPU's backward
//     rolls WRAP at the row end, so these reads index mod 65536;
//   * the profitability filter: other match starts in [i-16, i-1], zero
//     fill below 0 (no wrap);
//   * suffix propagation: 7 Hillis-Steele max levels (strict >, so ties
//     keep the right operand), masked below gidx = s, capped at 68;
//   * lazy deferral against position i+1 (0 at i = 65535), greedy jump.
// The two table forms differ only in the load: packed, keep 0 is `pref`
// and keeps 1.. are the 16-bit halves of the words in order (low first;
// at even K the last word's high half is not a keep); unpacked, keep j is
// column j of the (N, K) table.
//
// Bound on this card: integer operations, in the sticky levels. The exact
// membership test compares each of K+1 shifted offsets with K own offsets
// per level (at K = 14, 630 compares a position over the first three
// levels and 14 at the last, which only the default needs); the signature
// test builds K bucket bits and tests K+1 (about 2K+1 per level, plus K to
// verify); the kernel reads 4 + 2K bytes a position (packed) and writes 8.
// Each output needs a bounded neighbourhood: 203 positions to the left
// (sticky 60, filter 16, propagation 127) and 68 to the right (lengths and
// lazy). The design, for this card:
//   * One block of 512 threads owns a row's tile of 1776 outputs and loads
//     it with its halos, 2048 positions, four consecutive positions a
//     thread (16-byte loads and stores, no partial trip; the halos are 15%
//     of the positions, against 27% at the earlier 1024-output tile).
//   * Sticky planes are single-buffered in shared memory (K + 1 planes of
//     16-bit offsets): a thread computes its positions' new values into
//     registers (two to a register), the block synchronises, and the thread
//     writes them in place. The last level computes only the default. At
//     "sig" the keeps' bucket mask (the OR of the kept members' buckets)
//     stays in registers from level to level, and the original keeps stay
//     in shared memory for the verification, so the table is read from
//     device memory once.
//   * The stages after sticky are restated as few passes, positions kept in
//     registers: link counts are runs of a warp ballot of the stride-4
//     equalities (four chains a warp, the next warp's ballot for runs that
//     cross it); the phase max reads the next thread's offsets; the filter
//     counts a 20-bit window of per-thread match nibbles; the 7 propagation
//     levels are a sliding max over [i - 127, i] of the key (value + 1) <<
//     11 | region index (the largest key is the rightmost argmax, which the
//     strict > keeps), as per-warp prefix and suffix maxima (van Herk /
//     Gil-Werman: a warp holds one 128-position block). Eleven barriers a
//     tile in all (four in the stages after sticky).
// Blocks an SM: two at K 9-16 (64 registers a thread), three at K 5-8,
// four at K <= 4; one at K 17-24, where two blocks' sticky planes at "sig"
// (2K + 2 planes of 4 KB) pass the SM's 228 KB of shared memory, so a
// thread may take 128 registers. Up to K = 24 one block's planes fit its
// 227 KB at either sticky mode; past it the wide form holds no K planes.
#include "common.cuh"

namespace {

constexpr int kN = 1 << 16;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;                // consecutive positions a thread
constexpr int kLen = kThreads * kPer;  // a tile with its halos
// Left context: at least 60 + 16 + 127 positions; right: 64 (links) + 3
// (phases) + 1 (lazy).
constexpr int kLeft = 204;
constexpr int kRight = 68;
constexpr int kTile = kLen - kLeft - kRight;  // outputs a block
constexpr int kTiles = (kN + kTile - 1) / kTile;
constexpr int kLevels = 4;      // encode.STICKY_LEVELS
constexpr int kC1 = 2048;       // fmt.COPY1_MAX_OFFSET
constexpr int kBlock = 32 * kPer;  // a warp's positions, a max block
constexpr int kIdxBits = 11;    // region index bits of a window key
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFixedK = 24;     // the largest K with an instance of its own

static_assert(kLen == 1 << kIdxBits, "a window key holds a region index");
static_assert(kLeft % kPer == 0 && kTile % kPer == 0,
              "a thread's positions are all outputs or none");
static_assert(kLeft >= 60 + 16 + 127 && kBlock == 128,
              "the propagation window is one warp block");

// Shared memory of the stages after sticky (finish_tile): the suffix-max
// keys, the match nibbles, the stride-4 ballots and each warp's first key.
constexpr size_t kPostBytes =
    (kLen + kThreads + 4 + kWarps * kPer + kWarps) * sizeof(int32_t);

// Shared memory: the sticky planes (K + 1 planes of 16-bit values: the K
// keeps and the default), at "sig" the original keeps (K planes), then the
// sticky offsets. The later stages' arrays reuse the planes' space.
template <int K, bool kSig>
struct Smem {
  static constexpr size_t kPlanes = (K + 1) * kLen * sizeof(uint16_t);
  static constexpr size_t kOrig = kSig ? K * kLen * sizeof(uint16_t) : 0;
  static constexpr size_t kOffs = kLen * sizeof(uint16_t);
  static_assert(kPostBytes <= kPlanes, "the later stages fit in the planes");
  static constexpr size_t kTotal = kPlanes + kOrig + kOffs;
  static_assert(kTotal <= 227 * 1024, "a block's shared memory holds it");
};

__device__ __forceinline__ uint32_t sig_bit(uint32_t x) {
  return 1u << ((x * 0x9E3779B1u) >> 27);
}

// Four consecutive 16-bit values, one 8-byte store.
__device__ __forceinline__ void store4(uint16_t* at, uint32_t a, uint32_t b,
                                       uint32_t c, uint32_t d) {
  *reinterpret_cast<uint2*>(at) =
      make_uint2((a & 0xFFFFu) | (b & 0xFFFFu) << 16,
                 (c & 0xFFFFu) | (d & 0xFFFFu) << 16);
}

// The stages after sticky, on one block's tile: d holds my kPer sticky
// offsets (positions p0 .. p0 + 3 of the region, global gb .. gb + 3);
// offs is the region's plane of sticky offsets and post kPostBytes of
// shared memory, both free for this function. Writes my outputs.
__device__ __forceinline__ void finish_tile(
    const uint32_t (&d)[kPer], uint16_t* offs, unsigned char* post, int t0,
    int n, size_t rbase, int gb, int32_t* __restrict__ jump,
    int32_t* __restrict__ offo, int lazy) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p0 = kPer * tid;
  store4(offs + p0, d[0], d[1], d[2], d[3]);
  __syncthreads();

  // The later stages' arrays, in `post`.
  int32_t* hs = reinterpret_cast<int32_t*>(post);  // suffix-max keys
  uint32_t* hasw = reinterpret_cast<uint32_t*>(hs + kLen);  // match nibbles
  uint32_t* bal = hasw + kThreads + 4;  // stride-4 equality ballots
  int32_t* kfirst = reinterpret_cast<int32_t*>(bal + kWarps * kPer);

  // --- quantised lengths: runs of equal offsets along the four stride-4
  // chains. Equality with the next thread's offsets, balloted per chain;
  // a run is the trailing ones of this warp's ballot and the next's. ---
  uint32_t oq[kPer + 3];  // offsets at p0 .. p0 + 6
  {
    const bool last = tid + 1 == kThreads;
    const uint2 w = last ? make_uint2(0u, 0u)
                         : *reinterpret_cast<const uint2*>(offs + p0 + kPer);
    const uint32_t on[kPer] = {w.x & 0xFFFFu, w.x >> 16, w.y & 0xFFFFu,
                               w.y >> 16};
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      oq[q] = d[q];
      const uint32_t b = __ballot_sync(kFull, !last && on[q] == d[q]);
      if (lane == 0) bal[warp * kPer + q] = b;
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) oq[kPer + q] = on[q];
  }
  if (tid < 4) hasw[tid] = 0;
  __syncthreads();
  int mlq[kPer + 3];
#pragma unroll
  for (int c = 0; c < kPer + 3; ++c) {
    const int q = c % kPer;
    const uint32_t lo = bal[warp * kPer + q];
    const uint32_t hi = warp + 1 < kWarps ? bal[(warp + 1) * kPer + q] : 0u;
    // The chain's equalities from my lane (or the next) on; trailing ones,
    // capped at 16.
    const uint32_t ahead = __funnelshift_rc(lo, hi, lane + c / kPer);
    const int run = __ffs(~ahead | 1u << 16) - 1;
    mlq[c] = oq[c] != 0 ? 4 + 4 * run : 0;
  }

  // --- phase max over p = 1..3, capped at n - i ---
  int ml[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const uint32_t o = oq[q];
    int v = 0;
    if (o != 0) {
      v = mlq[q];
#pragma unroll
      for (int e = 1; e <= 3; ++e)
        if (oq[q + e] == o) v = max(v, e + mlq[q + e]);
    }
    ml[q] = min(v, n - (gb + q));
  }

  // --- profitability filter: match starts in [i - 16, i - 1], none
  // before the row (tile 0's left halo has no positions) ---
  const bool neg = t0 == 0 && p0 < kLeft;
  uint32_t nib = 0;
  if (!neg) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) nib |= static_cast<uint32_t>(ml[q] > 0) << q;
  }
  hasw[4 + tid] = nib;
  __syncthreads();
  const uint32_t win = hasw[tid] | hasw[tid + 1] << 4 | hasw[tid + 2] << 8 |
                       hasw[tid + 3] << 12 | nib << 16;
  int key[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int v = ml[q];
    const bool isolated = __popc((win >> q) & 0xFFFFu) == 0;
    const bool near = d[q] < kC1;
    const bool keep = (v >= 5 || near) && (v >= 6 || near || !isolated);
    const int pva = (keep ? v : 0) + gb + q;
    key[q] = neg ? p0 + q : (pva + 1) << kIdxBits | (p0 + q);
  }

  // --- suffix propagation: the sliding max of the keys over [p - 127, p],
  // a warp's prefix maxima with the previous warp's suffix maxima ---
  int g[kPer], h[kPer];
  g[0] = key[0];
#pragma unroll
  for (int q = 1; q < kPer; ++q) g[q] = max(g[q - 1], key[q]);
  h[kPer - 1] = key[kPer - 1];
#pragma unroll
  for (int q = kPer - 2; q >= 0; --q) h[q] = max(h[q + 1], key[q]);
  {
    const int pre = snk::warp_scan_max(g[kPer - 1]);
    int before = __shfl_up_sync(kFull, pre, 1);
    if (lane == 0) before = -1;
    int suf = h[0];
#pragma unroll
    for (int dd = 1; dd < 32; dd <<= 1) {
      const int o = __shfl_down_sync(kFull, suf, dd);
      if (lane + dd < 32) suf = max(suf, o);
    }
    int after = __shfl_down_sync(kFull, suf, 1);
    if (lane == 31) after = -1;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      g[q] = max(g[q], before);
      h[q] = max(h[q], after);
    }
  }
  *reinterpret_cast<int4*>(hs + p0) = make_int4(h[0], h[1], h[2], h[3]);
  if (lane == 0) kfirst[warp] = key[0];
  __syncthreads();

  // --- lazy deferral and the greedy jump, on my outputs ---
  int gn = __shfl_down_sync(kFull, g[0], 1);  // the window at p0 + kPer
  if (lane == 31) gn = warp + 1 < kWarps ? kfirst[warp + 1] : -1;
  const int q0 = p0 - kLeft;  // my first output of the tile
  if (q0 < 0 || q0 >= kTile || t0 + q0 >= kN) return;
  int wk[kPer + 1];
#pragma unroll
  for (int q = 0; q < kPer; ++q) wk[q] = max(g[q], hs[p0 + q - (kBlock - 1)]);
  wk[kPer] = max(gn, hs[p0 + kPer - (kBlock - 1)]);
  int jv[kPer], ov[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int gm = gb + q;
    int mlp = min((wk[q] >> kIdxBits) - 1 - gm, 68);
    if (lazy) {
      const int nx = gm == kN - 1
          ? 0 : min((wk[q + 1] >> kIdxBits) - 1 - (gm + 1), 68);
      if (mlp >= 4 && mlp < 64 && nx >= mlp + lazy) mlp = 0;
    }
    jv[q] = mlp < 4 ? 1 : (mlp <= 64 ? mlp : (mlp < 68 ? 60 : 64));
    ov[q] = offs[wk[q] & (kLen - 1)];
  }
  *reinterpret_cast<int4*>(jump + rbase + gb) =
      make_int4(jv[0], jv[1], jv[2], jv[3]);
  *reinterpret_cast<int4*>(offo + rbase + gb) =
      make_int4(ov[0], ov[1], ov[2], ov[3]);
}

template <int K, bool kSig>
__global__ void __launch_bounds__(
    kThreads, K <= 4 ? 4 : (K <= 8 ? 3 : (K <= 16 ? 2 : 1)))
matcher_kernel(const int32_t* __restrict__ pref,
               const int32_t* __restrict__ table, bool packed,
               const int32_t* __restrict__ nlen, int32_t* __restrict__ jump,
               int32_t* __restrict__ offo, int lazy) {
  extern __shared__ __align__(16) unsigned char smem[];
  using S = Smem<K, kSig>;
  constexpr int kP = K + 1;  // planes: keeps 0..K-1, default at K
  constexpr int kW = K / 2;
  uint16_t* planes = reinterpret_cast<uint16_t*>(smem);
  uint16_t* orig = planes + kP * kLen;  // "sig" only: the original keeps
  uint16_t* offs = reinterpret_cast<uint16_t*>(smem + S::kPlanes + S::kOrig);

  const int tid = threadIdx.x;
  const int row = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int n = nlen[row];
  const size_t rbase = static_cast<size_t>(row) * kN;
  const int p0 = kPer * tid;  // my first region position
  // Its global position; my kPer positions never straddle the wrap.
  const int gb = (t0 - kLeft + p0) & (kN - 1);

  // --- load the table: keeps 0..K-1, and the default = keep 0 ---
  if (packed) {
    const int4 pr = __ldg(reinterpret_cast<const int4*>(pref + rbase + gb));
    store4(planes + p0, pr.x, pr.y, pr.z, pr.w);
    store4(planes + K * kLen + p0, pr.x, pr.y, pr.z, pr.w);
    if constexpr (kSig) store4(orig + p0, pr.x, pr.y, pr.z, pr.w);
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      const int4 w = __ldg(reinterpret_cast<const int4*>(
          table + (static_cast<size_t>(row) * kW + j) * kN + gb));
      const uint32_t x = w.x, y = w.y, z = w.z, v = w.w;
      store4(planes + (1 + 2 * j) * kLen + p0, x, y, z, v);
      if constexpr (kSig) store4(orig + (1 + 2 * j) * kLen + p0, x, y, z, v);
      if (2 + 2 * j < K) {  // at even K the last high half is not a keep
        store4(planes + (2 + 2 * j) * kLen + p0, x >> 16, y >> 16, z >> 16,
               v >> 16);
        if constexpr (kSig)
          store4(orig + (2 + 2 * j) * kLen + p0, x >> 16, y >> 16, z >> 16,
                 v >> 16);
      }
    }
  } else {
    // My positions' K entries each: 4K consecutive int32.
    const int4* src = reinterpret_cast<const int4*>(
        table + (rbase + gb) * K);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int4 x = __ldg(src + i);
      const int vals[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = (4 * i + e) / K;
        const int j = (4 * i + e) % K;
        const uint16_t v = static_cast<uint16_t>(vals[e]);
        planes[j * kLen + p0 + q] = v;
        if (j == 0) planes[K * kLen + p0 + q] = v;
        if constexpr (kSig) orig[j * kLen + p0 + q] = v;
      }
    }
  }
  __syncthreads();

  // --- sticky offsets: keep the offset from i - s where it is one of my
  // keeps, per keep and for the default. New values wait in registers
  // (two to a register) until the block has read the level. At "sig" the
  // keeps' bucket mask stays in registers: the next level's mask is the OR
  // of the buckets of the members kept. ---
  uint32_t msk[kPer];
  if constexpr (kSig) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      msk[q] = 0;
#pragma unroll
      for (int m = 0; m < K; ++m) {
        const uint32_t own = planes[m * kLen + p0 + q];
        if (own != 0) msk[q] |= sig_bit(own);
      }
    }
  }
#pragma unroll 1
  for (int lvl = 0; lvl < kLevels - 1; ++lvl) {
    const int s = 4 << lvl;
    // Window edge (gidx < s), or context the tile never reads (p < s).
    const bool ident = gb < s || p0 < s;
    uint32_t nv[kP][2];
    uint32_t nm[kPer];
    if (!ident) {
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int p = p0 + q;
        uint32_t own[K];
        if constexpr (!kSig) {
#pragma unroll
          for (int m = 0; m < K; ++m) own[m] = planes[m * kLen + p];
        }
        nm[q] = 0;
#pragma unroll
        for (int j = 0; j < kP; ++j) {
          const uint32_t x = planes[j * kLen + p - s];
          bool hit = false;
          if constexpr (kSig) {
            const uint32_t b = sig_bit(x);
            hit = (msk[q] & b) != 0 && x != 0;
            if (j < K && hit) nm[q] |= b;
          } else {
#pragma unroll
            for (int m = 0; m < K; ++m) hit |= x == own[m];
            hit &= x != 0;
          }
          // keeps drop a non-member to 0; the default keeps its own value
          const uint32_t v = hit ? x : (j == K ? planes[K * kLen + p] : 0u);
          if (q & 1)
            nv[j][q >> 1] |= v << 16;
          else
            nv[j][q >> 1] = v;
        }
      }
    }
    __syncthreads();
    if (!ident) {
#pragma unroll
      for (int j = 0; j < kP; ++j)
        *reinterpret_cast<uint2*>(planes + j * kLen + p0) =
            make_uint2(nv[j][0], nv[j][1]);
      if constexpr (kSig) {
#pragma unroll
        for (int q = 0; q < kPer; ++q) msk[q] = nm[q];
      }
    }
    __syncthreads();
  }
  // The last level: only the default is read after it.
  uint32_t d[kPer];
  {
    constexpr int s = 4 << (kLevels - 1);
    const bool ident = gb < s || p0 < s;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int p = p0 + q;
      d[q] = planes[K * kLen + p];
      if (ident) continue;
      const uint32_t x = planes[K * kLen + p - s];
      bool hit = false;
      if constexpr (kSig) {
        hit = (msk[q] & sig_bit(x)) != 0;
      } else {
#pragma unroll
        for (int m = 0; m < K; ++m) hit |= x == planes[m * kLen + p];
      }
      if (hit && x != 0) d[q] = x;
    }
  }
  if constexpr (kSig) {
    // Exact re-verification against the original table, falling back to
    // the original keep 0.
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int p = p0 + q;
      const uint32_t c0 = orig[p];
      bool ver = d[q] == c0;
#pragma unroll
      for (int j = 1; j < K; ++j) ver |= d[q] == orig[j * kLen + p];
      d[q] = ver && d[q] != 0 ? d[q] : c0;
    }
  }
  finish_tile(d, offs, smem, t0, n, rbase, gb, jump, offo, lazy);
}

// --- The wide form: any K, as a runtime argument ---
//
// The keep sets compose by intersection. At "exact" a level keeps the
// members of the set at i - s that are also in the set at i, so after l
// levels the set at i (where i >= 4 (2^l - 1)) is the intersection of the
// original tables at i, i - 4, ..., i - 4 (2^l - 1), and the default moves
// from i - s to i exactly when it lies in all of them. At "sig" the kept
// members are those whose bucket is in my mask, so the masks compose by
// AND over the same window, and only the masks decide the default. So a
// position needs its own default, its mask and, at "exact", a membership
// test against the original table at the 2^l positions of its window (15
// a position over the four levels). No K planes are held, so the tile, the
// halos and the stages after sticky are the fixed form's.
//
// Bound on this card: the bytes of the table (4 + 2K a position packed, 4K
// unpacked). The design:
//   * Origins. A default is always keep 0 of a position 4m back (m <= 15
//     after four levels), so a default carries m beside its value, and the
//     test at window position i - 4j asks whether keep 0 of the position
//     4(r - j) before it is one of its keeps (r the candidate's origin).
//   * One streamed pass over the region's table builds each position's
//     32-bit bucket mask and, at "exact", its near bits: whether keep 0 of
//     each of the positions 4, 8 and 12 back is one of its keeps. Those
//     answer every test of the first two levels and the near ones after.
//     Packed, a thread reads its four positions' (K/2, N) words four
//     16-byte loads at a time and tests two keeps a word against a
//     candidate at once (w ^ (c | c << 16) has a zero half). Unpacked, four
//     lanes share a position and read its contiguous entries in 16-byte
//     steps (eight positions a warp load, where a thread's own four would
//     touch 32 lines), then OR their results with two shuffles.
//   * The other tests ask keep 0 of the window position in shared memory,
//     and the rest are the warp's scans of the table in device memory, each
//     warp load covering one word of many tests (warp_scan). A prefilter
//     keeps the scans few: the composed bucket mask, zero keeps included at
//     "exact" (a member of the window's intersection has its bucket in
//     every mask, so it never rejects one). A 128-bit signature let fewer
//     non-members through, but its seven more operations a keep cost more
//     than the scans it saved once the near bits answer the first two
//     levels. Scans a thread at a time, chains of L2 loads that read a
//     32-byte sector for 4 bytes, cost more than the mask pass itself.
//   * The masks and defaults are double-buffered in shared memory (one
//     barrier a level), beside the region's keep 0 and near bits.
//   * At "sig" the levels test only the masks, and the final verification
//     scans the position's own table where the default is not its keep 0,
//     one 16-byte load for four positions (own_scan).

// A position's mask: the 32-bit bucket mask (sig_bit) of its keeps, the
// zero keeps too at "exact" (there it only prefilters, and a bit more only
// admits more), the nonzero ones at "sig" (its bytes depend on it).
template <bool kSig>
struct Mask {
  uint32_t w = 0;

  __device__ __forceinline__ void add(uint32_t x) {
    w |= kSig && x == 0 ? 0u : sig_bit(x);
  }
  // Whether the mask admits x.
  __device__ __forceinline__ static bool admits(uint32_t mask, uint32_t x) {
    return (mask & sig_bit(x)) != 0;
  }
};

// A lane's tests a round of warp_scan, and a warp's.
constexpr int kJobsLane = 8;
constexpr int kJobsWarp = 32 * kJobsLane;

// Shared memory of the wide form: two buffers of the masks (u32) and the
// defaults (u32: the value, and at bits 16.. the origin m, the default being
// keep 0 of the position 4m back), then keep 0 of the region (u16), the
// near bits (u8), and each warp's list of tests for warp_scan (u32) and
// their hits (u8). The stages after sticky take the first buffer (the last
// level reads the second): the sticky offsets, then finish_tile's arrays.
template <bool kSig>
struct WideSmem {
  static constexpr size_t kMasks = kLen * 4;
  static constexpr size_t kBuf = kMasks + kLen * 4;
  static constexpr size_t kFinish = kLen * sizeof(uint16_t) + kPostBytes;
  static constexpr size_t kSlot =
      ((kBuf > kFinish ? kBuf : kFinish) + 15) / 16 * 16;
  static constexpr size_t kC0 = 2 * kSlot;
  static constexpr size_t kNearAt = kC0 + kLen * sizeof(uint16_t);
  static constexpr size_t kJobs = kNearAt + kLen;
  static constexpr size_t kHits = kJobs + kWarps * kJobsWarp * 4;
  static constexpr size_t kTotal = kHits + kWarps * kJobsWarp;
  static_assert(2 * kTotal <= 227 * 1024, "two blocks an SM");
};

// The near bits of a region position r at "exact": whether keep 0 of each
// of r - 4, r - 8, ..., r - 4 kNear (the candidates of the first two
// levels, whose defaults come from at most 12 positions back) is one of r's
// keeps. For P consecutive positions at once, the candidates read from the
// region's keep 0 in shared memory; packed keeps fed in two to a word (a
// half of w ^ (c | c << 16) is zero where that half is c), unpacked ones
// one at a time. At "sig" none.
constexpr int kNear = 3;

template <bool kSig, int P>
struct Near {
  static constexpr int kU = kSig ? 0 : kNear;
  uint32_t cc[kU > 0 ? kU : 1][P];   // candidates, in both halves
  uint32_t acc[kU > 0 ? kU : 1][P];  // a zero half seen

  // Positions p .. p + P - 1 (P 1 or kPer), their keep 0 `own`.
  __device__ __forceinline__ Near(const uint16_t* c0, int p,
                                  const uint32_t (&own)[P]) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
#pragma unroll
      for (int e = 0; e < P; ++e) {
        const int at = p + e - 4 * (u + 1);
        const uint32_t v = at >= 0 ? c0[at] : 0u;
        cc[u][e] = v | v << 16;
        acc[u][e] = v != 0 && v == own[e] ? 0x8000u : 0u;
      }
    }
  }
  // Keeps lo and hi (w's halves) of position e; `high` false: lo alone.
  __device__ __forceinline__ void test(int e, uint32_t w, bool high = true) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const uint32_t t = w ^ cc[u][e];
      const uint32_t z = (t - 0x10001u) & ~t & 0x80008000u;
      acc[u][e] |= high ? z : z & 0x8000u;
    }
  }
  // One keep v of position e.
  __device__ __forceinline__ void test1(int e, uint32_t v) {
#pragma unroll
    for (int u = 0; u < kU; ++u) acc[u][e] |= v == (cc[u][e] & 0xFFFFu);
  }
  // Position e's bits: bit u - 1 where the (nonzero) candidate was seen.
  __device__ __forceinline__ unsigned bits(int e) const {
    unsigned b = 0;
#pragma unroll
    for (int u = 0; u < kU; ++u)
      b |= static_cast<unsigned>(acc[u][e] != 0 && cc[u][e] != 0) << u;
    return b;
  }
};

// The table of one row. Packed: keep 0 is pref, keeps 1.. the 16-bit halves
// of the (K/2, N) words in order (low first; at even K the last word's high
// half is not a keep). Unpacked: the (N, K) entries.
template <bool kPacked>
struct Keeps {
  const int32_t* __restrict__ pref;
  const int32_t* __restrict__ table;
  int k;
  int row;

  // Keep 0 of every region position r into c0 (u16) and dflt (u32: the
  // default, origin 0). g0: the region's first global position.
  __device__ __forceinline__ void firsts(int g0, uint16_t* c0,
                                         uint32_t* dflt) const {
    const int p0 = kPer * threadIdx.x;
    uint32_t c[kPer];
    if constexpr (kPacked) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(
          pref + static_cast<size_t>(row) * kN + ((g0 + p0) & (kN - 1))));
      c[0] = v.x; c[1] = v.y; c[2] = v.z; c[3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) c[e] = first((g0 + p0 + e) & (kN - 1));
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e) c[e] &= 0xFFFFu;
    store4(c0 + p0, c[0], c[1], c[2], c[3]);
    *reinterpret_cast<uint4*>(dflt + p0) = make_uint4(c[0], c[1], c[2], c[3]);
  }

  // The mask pass, after firsts: the mask and, at "exact", the near bits
  // of every region position, into masks (u32) and near (u8).
  template <bool kSig>
  __device__ __forceinline__ void mask_pass(int g0, const uint16_t* c0,
                                            uint32_t* masks,
                                            unsigned char* near) const {
    const int tid = threadIdx.x;
    if constexpr (kPacked) {
      // My four positions' (K/2, N) words, 16 bytes a load, four loads in
      // flight.
      constexpr int kB = 4;
      const int p0 = kPer * tid;
      const int gb = (g0 + p0) & (kN - 1);
      uint32_t c[kPer];
      {
        const uint2 v = *reinterpret_cast<const uint2*>(c0 + p0);
        c[0] = v.x & 0xFFFFu; c[1] = v.x >> 16;
        c[2] = v.y & 0xFFFFu; c[3] = v.y >> 16;
      }
      Mask<kSig> m[kPer];
#pragma unroll
      for (int e = 0; e < kPer; ++e) m[e].add(c[e]);
      Near<kSig, kPer> nb(c0, p0, c);
      // Words whose both halves are keeps; at even K one more, its low half.
      const int kw = k / 2, full = (k - 1) / 2;
      const int4* at = words(gb);
      int j = 0;
      for (; j + kB <= full; j += kB) {
        int4 v[kB];
#pragma unroll
        for (int u = 0; u < kB; ++u) v[u] = __ldg(at + (j + u) * (kN / 4));
#pragma unroll
        for (int u = 0; u < kB; ++u) {
          const uint32_t x[kPer] = {static_cast<uint32_t>(v[u].x),
                                    static_cast<uint32_t>(v[u].y),
                                    static_cast<uint32_t>(v[u].z),
                                    static_cast<uint32_t>(v[u].w)};
#pragma unroll
          for (int e = 0; e < kPer; ++e) {
            m[e].add(x[e] & 0xFFFFu);
            m[e].add(x[e] >> 16);
            nb.test(e, x[e]);
          }
        }
      }
      for (; j < kw; ++j) {
        const int4 v = __ldg(at + j * (kN / 4));
        const uint32_t x[kPer] = {static_cast<uint32_t>(v.x),
                                  static_cast<uint32_t>(v.y),
                                  static_cast<uint32_t>(v.z),
                                  static_cast<uint32_t>(v.w)};
        const bool high = j < full;
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          m[e].add(x[e] & 0xFFFFu);
          if (high) m[e].add(x[e] >> 16);
          nb.test(e, x[e], high);
        }
      }
      *reinterpret_cast<uint4*>(masks + p0) =
          make_uint4(m[0].w, m[1].w, m[2].w, m[3].w);
      if constexpr (!kSig)
        *reinterpret_cast<uint32_t*>(near + p0) =
            nb.bits(0) | nb.bits(1) << 8 | nb.bits(2) << 16 | nb.bits(3) << 24;
    } else {
      // Four lanes a position, eight positions a warp load, a step of
      // kThreads / 4 positions. At K % 4 == 0 lane h reads the 16-byte
      // words h, h + 4, ... of its position's K entries; else the entries
      // h, h + 4, ...
      const int h = tid & 3;
#pragma unroll 4
      for (int r = tid >> 2; r < kLen; r += kThreads / 4) {
        const int32_t* at = entries((g0 + r) & (kN - 1));
        Mask<kSig> m;
        // Keep 0 is among the entries lane 0 reads.
        const uint32_t none[1] = {0};
        Near<kSig, 1> nb(c0, r, none);
        constexpr int e = 0;
        if (k % 4 == 0) {
          const int4* at4 = reinterpret_cast<const int4*>(at);
#pragma unroll 2
          for (int i = h; i < k / 4; i += 4) {
            const int4 v = __ldg(at4 + i);
            const uint32_t x[4] = {v.x & 0xFFFFu, v.y & 0xFFFFu,
                                   v.z & 0xFFFFu, v.w & 0xFFFFu};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              m.add(x[q]);
              nb.test1(e, x[q]);
            }
          }
        } else {
#pragma unroll 4
          for (int i = h; i < k; i += 4) {
            const uint32_t v = __ldg(at + i) & 0xFFFFu;
            m.add(v);
            nb.test1(e, v);
          }
        }
        m.w |= __shfl_xor_sync(kFull, m.w, 1);
        m.w |= __shfl_xor_sync(kFull, m.w, 2);
        unsigned bits = nb.bits(e);
        bits |= __shfl_xor_sync(kFull, bits, 1);
        bits |= __shfl_xor_sync(kFull, bits, 2);
        if (h == 0) {
          masks[r] = m.w;
          if constexpr (!kSig) near[r] = static_cast<unsigned char>(bits);
        }
      }
    }
  }

  // Keep 0 of global position g.
  __device__ __forceinline__ uint32_t first(int g) const {
    return static_cast<uint32_t>(
               kPacked ? __ldg(pref + static_cast<size_t>(row) * kN + g)
                       : __ldg(entries(g))) & 0xFFFFu;
  }

  // Bit e set where x[e] is one of keeps 1..K-1 of position g + e (g a
  // multiple of 4), for the positions of `want`: the "sig" verification,
  // where neighbouring positions mostly all ask, each with its own keeps.
  // Packed, one 16-byte load answers the four, four loads in flight, until
  // all are found; unpacked, a position's entries eight at a time.
  __device__ __forceinline__ unsigned own_scan(int g,
                                               const uint32_t (&x)[kPer],
                                               unsigned want) const {
    unsigned found = 0;
    if constexpr (kPacked) {
      const int kw = k / 2;
      const int4* at = words(g);
      for (int j = 0; j < kw && found != want; j += 4) {
        int4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[u] = j + u < kw ? __ldg(at + (j + u) * (kN / 4))
                            : make_int4(0, 0, 0, 0);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool in = j + u < kw;
          const bool high = 2 + 2 * (j + u) < k;
          const uint32_t w[kPer] = {static_cast<uint32_t>(v[u].x),
                                    static_cast<uint32_t>(v[u].y),
                                    static_cast<uint32_t>(v[u].z),
                                    static_cast<uint32_t>(v[u].w)};
#pragma unroll
          for (int e = 0; e < kPer; ++e)
            found |= static_cast<unsigned>(
                (in && (w[e] & 0xFFFF) == x[e]) ||
                (high && w[e] >> 16 == x[e])) << e;
        }
        found &= want;
      }
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        if (!(want >> e & 1)) continue;
        const int32_t* at = entries(g + e);
        bool hit = false;
        for (int c = 1; c < k && !hit; c += 8) {
          int v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u)
            v[u] = c + u < k ? __ldg(at + c + u) : 0;
#pragma unroll
          for (int u = 0; u < 8; ++u)
            hit |= c + u < k &&
                   static_cast<uint32_t>(v[u] & 0xFFFF) == x[e];
        }
        found |= static_cast<unsigned>(hit) << e;
      }
    }
    return found;
  }

  // The window tests that keep 0 did not answer, for the whole warp at
  // once (every lane calls it). Bit q + 4 j of `need`: x[q] must be one of
  // keeps 1..K-1 at global position gb + q - 4 j (gb my group's first,
  // gb + q - 4 j >= 0). Each lane posts its tests to the warp's list
  // (kJobsLane at a time); the warp splits the list's (test, word) pairs
  // over its lanes, so a round's loads are all in flight at once, and each
  // hit marks its test. Returns the bits of `need` found.
  __device__ __forceinline__ unsigned warp_scan(unsigned need,
                                                const uint32_t (&x)[kPer],
                                                int gb, uint32_t* job,
                                                unsigned char* hit) const {
    const int lane = threadIdx.x & 31;
    // A test's pairs: the words of the packed table (two keeps each), the
    // entries 1..K-1 of the unpacked one.
    const int per = kPacked ? k / 2 : k - 1;
    // t / per = umulhi(t, inv) for the t here; per 1 has no 32-bit inv.
    const uint32_t inv = 0xFFFFFFFFu / per + 1;
    const int gbase = gb - 4 * lane;  // lane 0's group (mod kN)
    unsigned found = 0;
    while (__any_sync(kFull, need)) {
      unsigned mine = 0;  // my next kJobsLane tests
      for (int i = 0; i < kJobsLane && need; ++i) {
        const unsigned b = need & (0u - need);
        mine |= b;
        need ^= b;
      }
      const int c = __popc(mine);
      int incl = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += o;
      }
      const int total = __shfl_sync(kFull, incl, 31);
      int at = incl - c;
      for (unsigned m = mine; m; m &= m - 1) {
        const int bit = __ffs(m) - 1;
        const int q = bit & 3;
        const uint32_t xq = q == 0 ? x[0] : q == 1 ? x[1] : q == 2 ? x[2]
                                                                   : x[3];
        job[at] = xq << 16 | static_cast<uint32_t>(lane) << 5 | bit;
        hit[at] = 0;
        ++at;
      }
      __syncwarp();
      const int pairs = total * per;
      // Packed, the pairs run word by word over the tests (the tests of
      // neighbouring positions share their 32-byte sectors within one
      // warp load); unpacked, test by test (a test's entries are
      // contiguous).
      const uint32_t tinv = 0xFFFFFFFFu / total + 1;
      for (int t0 = lane; t0 < pairs; t0 += 4 * 32) {
        uint32_t v[4], jw[4];
        int tj[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int t = t0 + 32 * u;
          v[u] = 0;
          jw[u] = 0;
          tj[u] = 0;
          if (t < pairs) {
            int tjob, w;
            if constexpr (kPacked) {
              w = total == 1 ? t : __umulhi(t, tinv);
              tjob = t - w * total;
            } else {
              tjob = per == 1 ? t : __umulhi(t, inv);
              w = t - tjob * per;
            }
            const uint32_t jwu = job[tjob];
            const int bit = jwu & 31;
            const int g = ((gbase + 4 * static_cast<int>(jwu >> 5 & 31)) &
                           (kN - 1)) + (bit & 3) - 4 * (bit >> 2);
            v[u] = kPacked ? __ldg(table + (static_cast<size_t>(row) *
                                            (k / 2) + w) * kN + g)
                           : __ldg(entries(g) + 1 + w);
            jw[u] = jwu;
            tj[u] = tjob | (w << 16);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (t0 + 32 * u >= pairs) continue;
          const uint32_t xv = jw[u] >> 16;
          const int w = tj[u] >> 16;
          const bool h = kPacked ? ((v[u] & 0xFFFFu) == xv ||
                                    (2 + 2 * w < k && v[u] >> 16 == xv))
                                 : (v[u] & 0xFFFFu) == xv;
          if (h) hit[tj[u] & 0xFFFF] = 1;
        }
      }
      __syncwarp();
      at = incl - c;
      for (unsigned m = mine; m; m &= m - 1) {
        if (hit[at]) found |= 1u << (__ffs(m) - 1);
        ++at;
      }
      __syncwarp();
    }
    return found;
  }

 private:
  // Word 0 of the int4 column of positions g..g+3; word j at + j * kN / 4.
  __device__ __forceinline__ const int4* words(int g) const {
    return reinterpret_cast<const int4*>(
        table + static_cast<size_t>(row) * (k / 2) * kN + g);
  }
  __device__ __forceinline__ const int32_t* entries(int g) const {
    return table + (static_cast<size_t>(row) * kN + g) * k;
  }
};

template <bool kPacked, bool kSig>
__global__ void __launch_bounds__(kThreads, 2)
matcher_wide_kernel(const int32_t* __restrict__ pref,
                    const int32_t* __restrict__ table, int k,
                    const int32_t* __restrict__ nlen,
                    int32_t* __restrict__ jump, int32_t* __restrict__ offo,
                    int lazy) {
  using S = WideSmem<kSig>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* c0 = reinterpret_cast<uint16_t*>(smem + S::kC0);
  unsigned char* near = smem + S::kNearAt;
  uint32_t* job = reinterpret_cast<uint32_t*>(smem + S::kJobs) +
                  (threadIdx.x >> 5) * kJobsWarp;
  unsigned char* hit = smem + S::kHits + (threadIdx.x >> 5) * kJobsWarp;
  auto masks = [&](int b) {
    return reinterpret_cast<uint32_t*>(smem + b * S::kSlot);
  };
  auto dflts = [&](int b) {
    return reinterpret_cast<uint32_t*>(smem + b * S::kSlot + S::kMasks);
  };

  const int tid = threadIdx.x;
  const int row = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int n = nlen[row];
  const size_t rbase = static_cast<size_t>(row) * kN;
  const int p0 = kPer * tid;  // my first region position
  const int gb = (t0 - kLeft + p0) & (kN - 1);
  const Keeps<kPacked> keeps{pref, table, k, row};

  keeps.firsts(t0 - kLeft, c0, dflts(0));
  // The near bits read other threads' keep 0; at "sig" a thread reads
  // only its own.
  if constexpr (!kSig) __syncthreads();
  keeps.template mask_pass<kSig>(t0 - kLeft, c0, masks(0), near);
  __syncthreads();
  // My defaults: the value, and at bits 16.. the origin m (the default is
  // keep 0 of the position 4m back; the keep sets after l levels hold
  // keep 0 of positions at most 4 (2^(l+1) - 1) back, 60 after four).
  uint32_t d[kPer];
  {
    const uint4 v = *reinterpret_cast<const uint4*>(dflts(0) + p0);
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  }

#pragma unroll 1
  for (int lvl = 0; lvl < kLevels; ++lvl) {
    const int cur = lvl & 1;
    const uint32_t* ms = masks(cur);
    const uint32_t* df = dflts(cur);
    const int s = 4 << lvl;
    // Window edge (gidx < s), or context the tile never reads (p < s).
    const bool ident = gb < s || p0 < s;
    uint32_t x[kPer] = {0, 0, 0, 0};  // candidates, with their origins
    unsigned take = 0;
    if (!ident) {
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        x[q] = df[p0 + q - s] + (static_cast<uint32_t>(s >> 2) << 16);
        const uint32_t v = x[q] & 0xFFFFu;
        take |= static_cast<unsigned>(
            v != 0 && Mask<kSig>::admits(ms[p0 + q], v)) << q;
      }
    }
    if constexpr (!kSig) {
      // In the original table at every position of my window (gb >= s, so
      // the window lies inside the row). The candidate is keep 0 of the
      // position 4r back, so the test at my group less 4j asks for keep 0
      // of the position 4(r - j) before it: its near bits answer it for
      // r - j <= kNear; else keep 0 from shared memory, then the warp's
      // scans of the rest. Bit q + 4j of `need` is asker q's scan there.
      unsigned need = 0;
      if (take) {
        for (int j = 0; j < 1 << lvl; ++j) {
          const uint2 c = *reinterpret_cast<const uint2*>(c0 + p0 - 4 * j);
          const uint32_t nb = *reinterpret_cast<const uint32_t*>(
              near + p0 - 4 * j);
          const uint32_t cv[kPer] = {c.x & 0xFFFFu, c.x >> 16, c.y & 0xFFFFu,
                                     c.y >> 16};
#pragma unroll
          for (int q = 0; q < kPer; ++q) {
            const int u = static_cast<int>(x[q] >> 16) - j;
            const bool by_bit = u <= kNear;
            const bool bit = nb >> ((8 * q + u - 1) & 31) & 1;
            take &= ~(static_cast<unsigned>(by_bit && !bit) << q);
            need |= static_cast<unsigned>(!by_bit && cv[q] != (x[q] & 0xFFFFu))
                    << (q + 4 * j);
          }
        }
        need &= take * 0x11111111u;
      }
      if (__any_sync(kFull, need)) {
        uint32_t xv[kPer];
#pragma unroll
        for (int q = 0; q < kPer; ++q) xv[q] = x[q] & 0xFFFFu;
        unsigned miss = need & ~keeps.warp_scan(need, xv, gb, job, hit);
        miss |= miss >> 16;
        miss |= miss >> 8;
        take &= ~(miss | miss >> 4);
      }
    }
    uint32_t nd[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) nd[q] = take >> q & 1 ? x[q] : d[q];
    if (lvl + 1 == kLevels) {  // nothing reads the last level's planes
#pragma unroll
      for (int q = 0; q < kPer; ++q) d[q] = nd[q];
      break;
    }
    {  // the masks compose by AND over the window
      uint4 own = *reinterpret_cast<const uint4*>(ms + p0);
      if (!ident) {
        const uint4 sh = *reinterpret_cast<const uint4*>(ms + p0 - s);
        own = make_uint4(own.x & sh.x, own.y & sh.y, own.z & sh.z,
                         own.w & sh.w);
      }
      *reinterpret_cast<uint4*>(masks(cur ^ 1) + p0) = own;
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q) d[q] = nd[q];
    *reinterpret_cast<uint4*>(dflts(cur ^ 1) + p0) =
        make_uint4(d[0], d[1], d[2], d[3]);
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) d[q] &= 0xFFFFu;
  if constexpr (kSig) {
    // Exact re-verification against my original keeps, falling back to
    // keep 0 (which passes it whenever the default equals it).
    const uint2 c = *reinterpret_cast<const uint2*>(c0 + p0);
    const uint32_t cv[kPer] = {c.x & 0xFFFFu, c.x >> 16, c.y & 0xFFFFu,
                               c.y >> 16};
    unsigned want = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q)
      want |= static_cast<unsigned>(d[q] != 0 && d[q] != cv[q]) << q;
    const unsigned ok = want ? keeps.own_scan(gb, d, want) : 0u;
#pragma unroll
    for (int q = 0; q < kPer; ++q)
      if (d[q] == 0 || (want >> q & 1 && !(ok >> q & 1))) d[q] = cv[q];
  }
  // The first buffer is free: the last level read the second.
  finish_tile(d, reinterpret_cast<uint16_t*>(smem),
              smem + kLen * sizeof(uint16_t), t0, n, rbase, gb, jump, offo,
              lazy);
}

template <bool kPacked, bool kSig>
int launch_wide(const void* pref, const void* table, int k, const void* n,
                void* jump, void* off, int lazy, int batch, cudaStream_t s) {
  const size_t bytes = WideSmem<kSig>::kTotal;
  cudaError_t err = cudaFuncSetAttribute(
      matcher_wide_kernel<kPacked, kSig>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(kTiles, batch);
  matcher_wide_kernel<kPacked, kSig><<<grid, kThreads, bytes, s>>>(
      static_cast<const int32_t*>(pref), static_cast<const int32_t*>(table),
      k, static_cast<const int32_t*>(n), static_cast<int32_t*>(jump),
      static_cast<int32_t*>(off), lazy);
  return static_cast<int>(cudaGetLastError());
}

// The wide kernel at any K >= 2.
int wide(const void* pref, const void* table, bool packed, const void* n,
         void* jump, void* off, int k, int lazy, int sig, int batch,
         cudaStream_t s) {
  if (k < 2) return static_cast<int>(cudaErrorInvalidValue);
  if (packed)
    return sig ? launch_wide<true, true>(pref, table, k, n, jump, off, lazy,
                                         batch, s)
               : launch_wide<true, false>(pref, table, k, n, jump, off, lazy,
                                          batch, s);
  return sig ? launch_wide<false, true>(pref, table, k, n, jump, off, lazy,
                                        batch, s)
             : launch_wide<false, false>(pref, table, k, n, jump, off, lazy,
                                         batch, s);
}

template <int K, bool kSig>
int launch(const void* pref, const void* table, bool packed, const void* n,
           void* jump, void* off, int lazy, int batch, cudaStream_t s) {
  const size_t bytes = Smem<K, kSig>::kTotal;
  cudaError_t err = cudaFuncSetAttribute(
      matcher_kernel<K, kSig>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(kTiles, batch);
  matcher_kernel<K, kSig><<<grid, kThreads, bytes, s>>>(
      static_cast<const int32_t*>(pref), static_cast<const int32_t*>(table),
      packed, static_cast<const int32_t*>(n), static_cast<int32_t*>(jump),
      static_cast<int32_t*>(off), lazy);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_k(const void* pref, const void* table, bool packed, const void* n,
             void* jump, void* off, int lazy, int sig, int batch,
             cudaStream_t s) {
  return sig ? launch<K, true>(pref, table, packed, n, jump, off, lazy,
                               batch, s)
             : launch<K, false>(pref, table, packed, n, jump, off, lazy,
                                batch, s);
}

int dispatch(const void* pref, const void* table, bool packed, const void* n,
             void* jump, void* off, int k, int lazy, int sig, int batch,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k > kFixedK)
    return wide(pref, table, packed, n, jump, off, k, lazy, sig, batch, s);
#define SNK_K(K)                                                       \
  case K:                                                              \
    return launch_k<K>(pref, table, packed, n, jump, off, lazy, sig, \
                       batch, s);
  switch (k) {
    SNK_K(2) SNK_K(3) SNK_K(4) SNK_K(5) SNK_K(6) SNK_K(7) SNK_K(8) SNK_K(9)
    SNK_K(10) SNK_K(11) SNK_K(12) SNK_K(13) SNK_K(14) SNK_K(15) SNK_K(16)
    SNK_K(17) SNK_K(18) SNK_K(19) SNK_K(20) SNK_K(21) SNK_K(22) SNK_K(23)
    SNK_K(24)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SNK_K
}

}  // namespace

// pref: (batch, 65536) int32; words: (batch, k/2, 65536) int32 (two 16-bit
// offsets each, low half first); n: (batch,) int32; jump, off: (batch,
// 65536) int32 outputs. k >= 2 (2..24: matcher_kernel<k>; above:
// matcher_wide_kernel); lazy >= 0 (0: no deferral); sig: 1 for sticky
// "sig", 0 for "exact".
SNK_EXPORT int snk_matcher_packed(const void* pref, const void* words,
                                  const void* n, void* jump, void* off, int k,
                                  int lazy, int sig, int batch, void* stream) {
  return dispatch(pref, words, true, n, jump, off, k, lazy, sig, batch,
                  stream);
}

// cands: (batch, 65536, k) int32, every entry below 65536; the rest as
// snk_matcher_packed.
SNK_EXPORT int snk_matcher(const void* cands, const void* n, void* jump,
                           void* off, int k, int lazy, int sig, int batch,
                           void* stream) {
  return dispatch(nullptr, cands, false, n, jump, off, k, lazy, sig, batch,
                  stream);
}

// The wide kernel at any K >= 2, the instances' K included (to time and
// hold it where they run): packed 1 takes pref and words as
// snk_matcher_packed, packed 0 takes the (batch, 65536, k) table as
// snk_matcher (pref unused); the rest as snk_matcher_packed.
SNK_EXPORT int snk_matcher_wide(const void* pref, const void* table,
                                int packed, const void* n, void* jump,
                                void* off, int k, int lazy, int sig,
                                int batch, void* stream) {
  return wide(pref, table, packed != 0, n, jump, off, k, lazy, sig, batch,
              static_cast<cudaStream_t>(stream));
}
