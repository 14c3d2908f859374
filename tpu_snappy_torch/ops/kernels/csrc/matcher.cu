// matcher: the fused encoder matcher, on the packed or the unpacked
// candidate table.
//
// Replaces tpu_snappy/ops/pallas/matcher.py:matcher_block_packed and
// matcher_block (sticky "exact" and "sig", K from 2 to 16). The TPU kernel
// holds a whole 64K row in VMEM and runs every stage as full-row
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
// Each output needs a bounded neighbourhood: 203 positions to the left
// (sticky 60, filter 16, propagation 127) and 68 to the right (lengths
// and lazy). So one block owns one row's tile of 1024 outputs, loads the
// tile plus halos (1296 positions) into shared memory as 16-bit offsets,
// and runs every stage there, the halos recomputed by each tile.
//
// Bound on this card: integer operations. The exact membership test
// compares each of K+1 shifted offsets with K own offsets per level
// (840 compares a position at K = 14), the signature test builds K bucket
// bits and tests K+1 (about 2K+1 per level, plus K to verify); the kernel
// reads 4 + 2K bytes a position (packed) and writes 8. It keeps every
// intermediate on chip, so device memory sees one read of the table (two
// of the verified positions' at "sig") and one write of (jump, off).
#include "common.cuh"

namespace {

constexpr int kN = 1 << 16;
constexpr int kTile = 1024;
constexpr int kLeft = 204;   // >= 60 + 16 + 127 positions of left context
constexpr int kRight = 68;   // 64 (links) + 3 (phases) + 1 (lazy)
constexpr int kLen = kLeft + kTile + kRight;
constexpr int kThreads = 512;
constexpr int kLevels = 4;   // encode.STICKY_LEVELS
constexpr int kC1 = 2048;    // fmt.COPY1_MAX_OFFSET

// Shared memory: the sticky double buffer (K + 1 planes of 16-bit values:
// the K keeps and the default), then the sticky offsets. The later stages'
// int32 arrays reuse the double buffer's space.
template <int K>
struct Smem {
  static constexpr size_t kSticky = 2u * (K + 1) * kLen * sizeof(uint16_t);
  static constexpr size_t kStage = 6u * kLen * sizeof(int32_t);
  static constexpr size_t kBig = kSticky > kStage ? kSticky : kStage;
  static constexpr size_t kTotal = kBig + kLen * sizeof(int32_t);
};

__device__ __forceinline__ uint32_t sig_bit(uint32_t x) {
  return 1u << ((x * 0x9E3779B1u) >> 27);
}

// Keep j of the original table at global position gm of row `row`.
// Packed: `table` is the words (row, K/2, N), `pref` keep 0. Unpacked:
// `table` is (row, N, K).
template <int K>
__device__ __forceinline__ uint16_t orig_keep(const int32_t* pref,
                                              const int32_t* table,
                                              bool packed, int row, int gm,
                                              int j) {
  if (!packed)
    return static_cast<uint16_t>(
        table[(static_cast<size_t>(row) * kN + gm) * K + j]);
  if (j == 0)
    return static_cast<uint16_t>(pref[static_cast<size_t>(row) * kN + gm]);
  const uint32_t w = static_cast<uint32_t>(
      table[(static_cast<size_t>(row) * (K / 2) + (j - 1) / 2) * kN + gm]);
  return static_cast<uint16_t>((j - 1) % 2 ? w >> 16 : w & 0xFFFFu);
}

template <int K, bool kSig>
__global__ void __launch_bounds__(kThreads)
matcher_kernel(const int32_t* __restrict__ pref,
               const int32_t* __restrict__ table, bool packed,
               const int32_t* __restrict__ nlen, int32_t* __restrict__ jump,
               int32_t* __restrict__ offo, int lazy) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kP = K + 1;  // planes: keeps 0..K-1, default at K
  constexpr int kW = K / 2;
  uint16_t* bufa = reinterpret_cast<uint16_t*>(smem);
  uint16_t* bufb = bufa + kP * kLen;
  int32_t* offs = reinterpret_cast<int32_t*>(smem + Smem<K>::kBig);

  const int tid = threadIdx.x;
  const int row = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int g0 = t0 - kLeft;  // global position of region index 0
  const int n = nlen[row];
  const size_t rbase = static_cast<size_t>(row) * kN;

  // --- load the table: keeps 0..K-1, and the default = keep 0 ---
  if (packed) {
    for (int p = tid; p < kLen; p += kThreads) {
      const int gm = (g0 + p) & (kN - 1);
      const uint16_t pr = static_cast<uint16_t>(pref[rbase + gm]);
      bufa[p] = pr;
      bufa[K * kLen + p] = pr;  // default
#pragma unroll
      for (int j = 0; j < kW; ++j) {
        const uint32_t w = static_cast<uint32_t>(
            table[(static_cast<size_t>(row) * kW + j) * kN + gm]);
        bufa[(1 + 2 * j) * kLen + p] = static_cast<uint16_t>(w & 0xFFFFu);
        if (2 + 2 * j < K)  // at even K the last high half is not a keep
          bufa[(2 + 2 * j) * kLen + p] = static_cast<uint16_t>(w >> 16);
      }
    }
  } else {
    // Consecutive threads read consecutive entries of the (N, K) rows.
    for (int f = tid; f < kLen * K; f += kThreads) {
      const int p = f / K;
      const int j = f - p * K;
      const int gm = (g0 + p) & (kN - 1);
      const uint16_t v = static_cast<uint16_t>(
          table[(rbase + gm) * K + j]);
      bufa[j * kLen + p] = v;
      if (j == 0) bufa[K * kLen + p] = v;
    }
  }
  __syncthreads();

  // --- sticky offsets: keep the offset from i - s where it is one of my
  // keeps, per keep and for the default ---
  uint16_t* cur = bufa;
  uint16_t* nxt = bufb;
#pragma unroll 1
  for (int lvl = 0; lvl < kLevels; ++lvl) {
    const int s = 4 << lvl;
    for (int p = tid; p < kLen; p += kThreads) {
      const int gm = (g0 + p) & (kN - 1);
      if (gm < s || p < s) {  // window edge (p < s: context never read)
#pragma unroll
        for (int j = 0; j < kP; ++j) nxt[j * kLen + p] = cur[j * kLen + p];
        continue;
      }
      uint32_t own[K];
      uint32_t mask = 0;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        own[j] = cur[j * kLen + p];
        if constexpr (kSig) {
          if (own[j] != 0) mask |= sig_bit(own[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kP; ++j) {
        const uint32_t x = cur[j * kLen + p - s];
        bool hit = false;
        if constexpr (kSig) {
          hit = (mask & sig_bit(x)) != 0;
        } else {
#pragma unroll
          for (int m = 0; m < K; ++m) hit |= x == own[m];
        }
        hit &= x != 0;
        // keeps drop a non-member to 0; the default keeps its own value
        nxt[j * kLen + p] = static_cast<uint16_t>(
            hit ? x : (j == K ? cur[K * kLen + p] : 0u));
      }
    }
    __syncthreads();
    uint16_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int p = tid; p < kLen; p += kThreads) {
    uint32_t d = cur[K * kLen + p];
    if constexpr (kSig) {
      // Exact re-verification against the original table (the double
      // buffer no longer holds it), falling back to the original keep 0.
      const int gm = (g0 + p) & (kN - 1);
      const uint16_t c0 = orig_keep<K>(pref, table, packed, row, gm, 0);
      bool ver = d == c0;
#pragma unroll
      for (int j = 1; j < K; ++j)
        ver |= d == orig_keep<K>(pref, table, packed, row, gm, j);
      d = ver && d != 0 ? d : c0;
    }
    offs[p] = static_cast<int32_t>(d);
  }
  __syncthreads();

  // Stage arrays in the (now dead) sticky buffer.
  int32_t* mlq = reinterpret_cast<int32_t*>(smem);
  int32_t* ml = mlq + kLen;
  int32_t* pva = ml + kLen;
  int32_t* poa = pva + kLen;
  int32_t* pvb = poa + kLen;
  int32_t* pob = pvb + kLen;

  // --- quantised lengths: consecutive equal offsets at stride 4 ---
  constexpr int kMl0 = kLeft - 127 - 16;  // first position the filter reads
  for (int p = kMl0 + tid; p < kLen - 64; p += kThreads) {
    const int o = offs[p];
    int r = 0;
    if (o != 0) {
      while (r < 16 && offs[p + 4 * (r + 1)] == o) ++r;
    }
    mlq[p] = o != 0 ? 4 + 4 * r : 0;
  }
  __syncthreads();

  // --- phase max over p = 1..3, masked, capped at n - i ---
  constexpr int kEnd = kLeft + kTile + 1;  // one past the lazy look-ahead
  for (int p = kMl0 + tid; p < kEnd; p += kThreads) {
    const int gm = (g0 + p) & (kN - 1);
    const int o = offs[p];
    int v = 0;
    if (o != 0) {
      v = mlq[p];
#pragma unroll
      for (int q = 1; q <= 3; ++q)
        if (offs[p + q] == o) v = max(v, q + mlq[p + q]);
    }
    ml[p] = min(v, n - gm);
  }
  __syncthreads();

  // --- profitability filter, then propagation's level-0 values ---
  constexpr int kPv0 = kLeft - 127;
  for (int p = kPv0 + tid; p < kEnd; p += kThreads) {
    const int gm = (g0 + p) & (kN - 1);
    const int v = ml[p];
    int before = 0;
#pragma unroll
    for (int d = 1; d <= 16; ++d)
      if (d <= gm) before += ml[p - d] > 0;
    const bool isolated = before == 0;
    const bool near = offs[p] < kC1;
    const bool keep = (v >= 5 || near) && (v >= 6 || near || !isolated);
    pva[p] = (keep ? v : 0) + gm;
    poa[p] = offs[p];
  }
  __syncthreads();

  // --- suffix propagation: windowed max-plus, 7 levels ---
#pragma unroll 1
  for (int lvl = 0; lvl < 7; ++lvl) {
    const int s = 1 << lvl;
    for (int p = kPv0 + tid; p < kEnd; p += kThreads) {
      const int gm = (g0 + p) & (kN - 1);
      int v = pva[p];
      int o = poa[p];
      // p - s < kPv0 only feeds positions left of the tile's context
      if (gm >= s && p - s >= kPv0) {
        const int av = pva[p - s];
        if (av > v) {
          v = av;
          o = poa[p - s];
        }
      }
      pvb[p] = v;
      pob[p] = o;
    }
    __syncthreads();
    int32_t* t = pva; pva = pvb; pvb = t;
    t = poa; poa = pob; pob = t;
  }

  // --- lazy deferral and the greedy jump ---
  for (int q = tid; q < kTile; q += kThreads) {
    const int p = kLeft + q;
    const int gm = t0 + q;
    int mlp = min(pva[p] - gm, 68);
    if (lazy) {
      const int nx = gm == kN - 1 ? 0 : min(pva[p + 1] - (gm + 1), 68);
      if (mlp >= 4 && mlp < 64 && nx >= mlp + lazy) mlp = 0;
    }
    const int j = mlp < 4 ? 1 : (mlp <= 64 ? mlp : (mlp < 68 ? 60 : 64));
    jump[rbase + gm] = j;
    offo[rbase + gm] = poa[p];
  }
}

template <int K, bool kSig>
int launch(const void* pref, const void* table, bool packed, const void* n,
           void* jump, void* off, int lazy, int batch, cudaStream_t s) {
  const size_t bytes = Smem<K>::kTotal;
  cudaError_t err = cudaFuncSetAttribute(
      matcher_kernel<K, kSig>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(kN / kTile, batch);
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
#define SNK_K(K)                                                       \
  case K:                                                              \
    return launch_k<K>(pref, table, packed, n, jump, off, lazy, sig, \
                       batch, s);
  switch (k) {
    SNK_K(2) SNK_K(3) SNK_K(4) SNK_K(5) SNK_K(6) SNK_K(7) SNK_K(8) SNK_K(9)
    SNK_K(10) SNK_K(11) SNK_K(12) SNK_K(13) SNK_K(14) SNK_K(15) SNK_K(16)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SNK_K
}

}  // namespace

// pref: (batch, 65536) int32; words: (batch, k/2, 65536) int32 (two 16-bit
// offsets each, low half first); n: (batch,) int32; jump, off: (batch,
// 65536) int32 outputs. k 2..16; lazy >= 0 (0: no deferral); sig: 1 for
// sticky "sig", 0 for "exact".
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
