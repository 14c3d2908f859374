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
// test against the original table at 2^l positions a level (15 in all),
// which the table in device memory answers: neighbouring threads read
// neighbouring positions, and the 28 positions of a window stay in L1.
// The bucket mask filters first at "exact" too (a member's bucket is in
// every mask of its window), and the test stops at the first position that
// lacks it. No K planes are held: the default and mask planes take 12 KB,
// so the tile, the halos and the stages after sticky are the fixed form's.
//
// Bound on this card: the bytes of the table (4 + 2K a position, packed)
// and, at "exact", the window tests (at most 15 K compares a position, where
// the fixed form makes about 3 K^2).

// Keeps of the table, four consecutive positions q0 .. q0 + 3 of one row
// at a time (q0 a multiple of 4). Packed: keep 0 is pref, keeps 1.. the
// 16-bit halves of the (K/2, N) words in order (low first; at even K the
// last word's high half is not a keep). Unpacked: the (N, K) entries.
template <bool kPacked>
struct Keeps {
  const int32_t* __restrict__ pref;
  const int32_t* __restrict__ table;
  int k;
  int row;

  // Keep 0 of each position.
  __device__ __forceinline__ void first(int q0, uint32_t (&c)[kPer]) const {
    if constexpr (kPacked) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(
          pref + static_cast<size_t>(row) * kN + q0));
      c[0] = x.x & 0xFFFF; c[1] = x.y & 0xFFFF;
      c[2] = x.z & 0xFFFF; c[3] = x.w & 0xFFFF;
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        c[e] = __ldg(entries(q0 + e)) & 0xFFFF;
    }
  }

  // The OR of the bucket bits of each position's nonzero keeps.
  __device__ __forceinline__ void masks(int q0, uint32_t (&m)[kPer]) const {
#pragma unroll
    for (int e = 0; e < kPer; ++e) m[e] = 0;
    if constexpr (kPacked) {
      uint32_t c[kPer];
      first(q0, c);
#pragma unroll
      for (int e = 0; e < kPer; ++e) m[e] |= bit(c[e]);
      for (int j = 0; j < k / 2; ++j) {
        const int4 x = word(j, q0);
        const uint32_t w[kPer] = {static_cast<uint32_t>(x.x),
                                  static_cast<uint32_t>(x.y),
                                  static_cast<uint32_t>(x.z),
                                  static_cast<uint32_t>(x.w)};
        const bool high = 2 + 2 * j < k;
#pragma unroll
        for (int e = 0; e < kPer; ++e)
          m[e] |= bit(w[e] & 0xFFFF) | (high ? bit(w[e] >> 16) : 0u);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int32_t* at = entries(q0 + e);
        for (int c = 0; c < k; ++c) m[e] |= bit(__ldg(at + c) & 0xFFFF);
      }
    }
  }

  // Bit e set where x[e] is a keep of position q0 + e, for the positions
  // of `want` (bits); stops once all of them are found.
  __device__ __forceinline__ unsigned member(int q0, const uint32_t (&x)[kPer],
                                             unsigned want) const {
    unsigned found = 0;
    if constexpr (kPacked) {
      uint32_t c[kPer];
      first(q0, c);
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        found |= static_cast<unsigned>(c[e] == x[e]) << e;
      found &= want;
      for (int j = 0; j < k / 2 && found != want; ++j) {
        const int4 v = word(j, q0);
        const uint32_t w[kPer] = {static_cast<uint32_t>(v.x),
                                  static_cast<uint32_t>(v.y),
                                  static_cast<uint32_t>(v.z),
                                  static_cast<uint32_t>(v.w)};
        const bool high = 2 + 2 * j < k;
#pragma unroll
        for (int e = 0; e < kPer; ++e)
          found |= static_cast<unsigned>((w[e] & 0xFFFF) == x[e] ||
                                         (high && w[e] >> 16 == x[e])) << e;
        found &= want;
      }
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        if (!(want >> e & 1)) continue;
        const int32_t* at = entries(q0 + e);
        for (int c = 0; c < k; ++c) {
          if (static_cast<uint32_t>(__ldg(at + c) & 0xFFFF) == x[e]) {
            found |= 1u << e;
            break;
          }
        }
      }
    }
    return found;
  }

 private:
  __device__ __forceinline__ static uint32_t bit(uint32_t v) {
    return v ? sig_bit(v) : 0u;
  }
  __device__ __forceinline__ int4 word(int j, int q0) const {
    return __ldg(reinterpret_cast<const int4*>(
        table + (static_cast<size_t>(row) * (k / 2) + j) * kN + q0));
  }
  __device__ __forceinline__ const int32_t* entries(int q) const {
    return table + (static_cast<size_t>(row) * kN + q) * k;
  }
};

// Shared memory of the wide form: the bucket masks and the defaults of the
// region (the stages after sticky reuse them), then the sticky offsets.
constexpr size_t kWideMasks = kLen * sizeof(uint32_t);
constexpr size_t kWideDflts = kLen * sizeof(uint16_t);
constexpr size_t kWideBytes = kWideMasks + 2 * kWideDflts;
static_assert(kPostBytes <= kWideMasks + kWideDflts,
              "the later stages fit in the sticky planes");

template <bool kPacked, bool kSig>
__global__ void __launch_bounds__(kThreads, 2)
matcher_wide_kernel(const int32_t* __restrict__ pref,
                    const int32_t* __restrict__ table, int k,
                    const int32_t* __restrict__ nlen,
                    int32_t* __restrict__ jump, int32_t* __restrict__ offo,
                    int lazy) {
  __shared__ __align__(16) unsigned char smem[kWideBytes];
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem);
  uint16_t* dflts = reinterpret_cast<uint16_t*>(smem + kWideMasks);
  uint16_t* offs = dflts + kLen;

  const int tid = threadIdx.x;
  const int row = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int n = nlen[row];
  const size_t rbase = static_cast<size_t>(row) * kN;
  const int p0 = kPer * tid;  // my first region position
  const int gb = (t0 - kLeft + p0) & (kN - 1);
  const Keeps<kPacked> keeps{pref, table, k, row};

  uint32_t c0[kPer], msk[kPer], d[kPer];
  keeps.first(gb, c0);
  keeps.masks(gb, msk);
#pragma unroll
  for (int q = 0; q < kPer; ++q) d[q] = c0[q];
  store4(dflts + p0, d[0], d[1], d[2], d[3]);
  *reinterpret_cast<uint4*>(masks + p0) =
      make_uint4(msk[0], msk[1], msk[2], msk[3]);
  __syncthreads();

#pragma unroll 1
  for (int lvl = 0; lvl < kLevels; ++lvl) {
    const int s = 4 << lvl;
    // Window edge (gidx < s), or context the tile never reads (p < s).
    const bool ident = gb < s || p0 < s;
    uint32_t nd[kPer], nm[kPer];
    if (!ident) {
      uint32_t x[kPer];
      unsigned take = 0;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        x[q] = dflts[p0 + q - s];
        take |= static_cast<unsigned>(x[q] != 0 &&
                                      (msk[q] & sig_bit(x[q])) != 0) << q;
      }
      if constexpr (!kSig) {
        // In the original table at every position of my window (gb >= s,
        // so the window lies inside the row).
        for (int i = 0; i < 1 << lvl && take; ++i)
          take = keeps.member(gb - 4 * i, x, take);
      }
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        nd[q] = take >> q & 1 ? x[q] : d[q];
        nm[q] = masks[p0 + q - s] & msk[q];
      }
    }
    if (lvl + 1 == kLevels) {  // nothing reads the last level's planes
      if (!ident) {
#pragma unroll
        for (int q = 0; q < kPer; ++q) d[q] = nd[q];
      }
      break;
    }
    __syncthreads();
    if (!ident) {
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        d[q] = nd[q];
        msk[q] = nm[q];
      }
      store4(dflts + p0, d[0], d[1], d[2], d[3]);
      *reinterpret_cast<uint4*>(masks + p0) =
          make_uint4(msk[0], msk[1], msk[2], msk[3]);
    }
    __syncthreads();
  }
  if constexpr (kSig) {
    // Exact re-verification against my original keeps, falling back to
    // keep 0 (which passes it whenever the default equals it).
    unsigned want = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q)
      want |= static_cast<unsigned>(d[q] != 0 && d[q] != c0[q]) << q;
    const unsigned ok = want ? keeps.member(gb, d, want) : 0u;
#pragma unroll
    for (int q = 0; q < kPer; ++q)
      if (d[q] == 0 || (want >> q & 1 && !(ok >> q & 1))) d[q] = c0[q];
  }
  finish_tile(d, offs, smem, t0, n, rbase, gb, jump, offo, lazy);
}

template <bool kPacked, bool kSig>
int launch_wide(const void* pref, const void* table, int k, const void* n,
                void* jump, void* off, int lazy, int batch, cudaStream_t s) {
  dim3 grid(kTiles, batch);
  matcher_wide_kernel<kPacked, kSig><<<grid, kThreads, 0, s>>>(
      static_cast<const int32_t*>(pref), static_cast<const int32_t*>(table),
      k, static_cast<const int32_t*>(n), static_cast<int32_t*>(jump),
      static_cast<int32_t*>(off), lazy);
  return static_cast<int>(cudaGetLastError());
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
  if (k > kFixedK) {
    if (packed)
      return sig ? launch_wide<true, true>(pref, table, k, n, jump, off,
                                           lazy, batch, s)
                 : launch_wide<true, false>(pref, table, k, n, jump, off,
                                            lazy, batch, s);
    return sig ? launch_wide<false, true>(pref, table, k, n, jump, off, lazy,
                                          batch, s)
               : launch_wide<false, false>(pref, table, k, n, jump, off,
                                           lazy, batch, s);
  }
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
