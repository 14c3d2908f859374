// resolve_tiled: out[p] = lit[fix(src)[p]], fix = src iterated to its
// fixed point, for maps with src[p] <= p (copy sources lie behind);
// resolve_tiled_depth, the same tile walk with a given number of rounds a
// tile; and resolve_tiled_flag, the walk steered by per-lane root flags.
// Every kernel takes every tile the TPU kernels take: 128 << k positions,
// k = 0..9.
//
// Replaces tpu_snappy/ops/pallas/tiledres.py:resolve_tiled (every
// variant: "fori", "pair", "tri" and "grid" give the same bytes, and
// `check` only groups rounds between convergence tests, with its
// `resolved` flag), tiledres.py:resolve_tiled_depth and
// tiledres.py:resolve_tiled_flag.
//
// What the TPU computes. Its kernels walk a row's tiles left to right. In
// tile t (base b) they run pointer doubling inside the tile (a lane whose
// pointer v lies in the tile moves to s[v]), then absorb: out[p] = lit[v]
// where the lane's final pointer v >= b (the byte plane still holds
// literals there), else out[v] (an earlier tile, already final). How many
// doubling rounds a tile runs:
//   * resolve_tiled: at most bit_length(tile) (13 at 4096), stopping
//     after the first round (or group of `check` rounds) that moves
//     nothing; none at all in a row whose `resolved` flag is set (the
//     caller's proof that src is at its fixed point);
//   * resolve_tiled_depth: exactly min(max(depths[t], 0), bit_length(tile))
//     rounds, whether or not the tile is then at its local fixed point, so
//     an under-declared depth gives the TPU's own wrong bytes (the framed
//     chunk CRC rejects them). A round that moves nothing changes nothing,
//     so the loop may stop there;
//   * resolve_tiled_flag: a flag f[q] ("my pointer is at a root") rides
//     beside each pointer, and a round moves both, s2 = s[d] and f2 =
//     f[d], from one snapshot. The tile runs rounds while some lane points
//     in-tile with f == 0, at most bit_length(tile), on the current state;
//     no `moved` break and no `resolved` skip, exactly the TPU's loop
//     (tiledres.py:_make_kernel_flag). Exact flags end each tile after its
//     productive rounds; an over-approximate flag (1 on an unresolved
//     lane) stops a tile early and gives the TPU's own wrong bytes, and
//     all-zero or under-approximate flags run more rounds and stay exact.
//
// The three kernels keep the walk's bytes but not its order: one block of
// 1024 threads a row, the row's map in shared memory as uint16 (128 KB;
// 0 <= src[p] <= p < 65536, so 16 bits are exact), then its literal bytes
// (64 KB; lit holds bytes), 192 KB of dynamic shared memory, and no step
// that waits for the tile before it:
//   1. load the map with 16-byte loads, the whole row at once, and
//      prefetch lit into L2 behind it (resolve_tiled_flag reads its flags
//      first, to choose its route, and loads them as bytes, also 16 bytes
//      a load, into the 64 KB that lit's bytes take only at the write
//      where its rounds need them);
//   2. local rounds in every tile at once, synchronous (every lane reads,
//      a vote, every lane writes): resolve_tiled_depth runs exactly the
//      declared count, since an under-declared depth must leave the TPU's
//      state after exactly that many rounds; resolve_tiled runs them until
//      nothing moves (see below); resolve_tiled_flag votes before each
//      round, on the current state, whether some lane points in-tile at a
//      non-root, and ends the tile's loop where the TPU's ends, or earlier
//      at a round that moves no pointer (the pointers' rounds do not read
//      the flags, so the bytes are the TPU's though its loop would go on).
//      A tile's rounds read only its own lanes (a pointer left of the tile
//      never moves, and src[p] <= p keeps every pointer below the tile's
//      end), so the tiles need no order. Up to 1024-tiles a tile runs on
//      one warp with no barrier shared with another tile (a warp holds
//      2048 lanes, so it runs 2048 / tile tiles one after the other); a
//      larger tile spans tile / 2048 warps, and its rounds take the block
//      barrier (named barriers, one a tile, would need 16 at the
//      4096-tile: all the card has, the block's own among them), a tile
//      whose loop has ended only waiting at the barriers;
//   3. the absorbs, as merges: a lane is terminal when its pointer v lies
//      at or right of its tile base (the walk gives it lit[v]); any other
//      lane's pointer lies in an earlier tile, where the walk gives it
//      out[v]. Level k merges pairs of blocks of 2^k tiles: a lane of the
//      right block whose pointer lies in the left one takes that lane's
//      pointer unless it is terminal. log2(tiles) levels (from 9 at the
//      128-tile to none at 65536), a block barrier each, instead of
//      `tiles` serial absorbs; then every non-terminal lane points at a
//      terminal lane, where the walk's recursion out[p] = out[v] ends;
//   4. stage lit's bytes from L2 into shared memory, and write out[p] =
//      lit[s[p]] for a terminal lane, lit[s[s[p]]] for another, as int32,
//      with 16-byte stores.
// The tile is a template parameter (kShift, its log2) of every kernel, so
// that the merge levels stay unrolled with constant block tests; the
// entry points pick the instance. resolve_tiled_depth and
// resolve_tiled_flag merge at the caller's tile: step 3's terminal test
// is the walk's rule whatever state the rounds left (an under-declared
// depth's or an over-approximate flag's included), since the rounds keep
// src[p] <= p.
// resolve_tiled's route. A `resolved` row runs the walk's absorbs alone:
// merges of tiles on src, at the caller's tile. In any other row the
// walk's rounds (at most bit_length(tile) a tile, stopping when none
// moves) always reach each tile's local fixed point (a chain inside a
// tile has fewer than `tile` hops, and log2(tile) rounds cover it), and
// the absorbs compose those points: the row's bytes are lit[fix(src)],
// whatever the tile, the check and the variant. So the kernel takes the
// cheaper route to the same bytes at every tile: rounds until nothing
// moves in 1024-tiles (at most 11), then merges of 1024-tiles that follow
// every pointer to its root, out[p] = lit[s[p]].
// resolve_tiled_flag's route. A flag of 1 on a lane whose pointer is not a
// root (an over-approximate flag) is what can stop a tile before its local
// fixed point. One pass over the row looks for one; a row without takes
// resolve_tiled's route above (a round carries a root's flag to the lane
// whose pointer it sets to that root, so every flag of 1 stays on a lane at
// a root, a tile's vote stays open while some in-tile pointer is not at a
// root, and the walk's bytes are lit[fix(src)] at every tile). A row with
// one runs the flag rounds of step 2 at the caller's tile, then step 3's
// merges there. The decoder's flags are exact, so its rows take the first
// route. The flag rounds cost more a round than the plain rounds: each
// reads every pair of every live tile with its flags, which ride in
// registers as bits beside the pointers, and votes twice.
// Bound on this card: at a 128-row wave, the row's bytes (lit, src, out:
// 768 KB a row; 1 MB with resolve_tiled_flag's flags) for the loads and
// stores, which the L2 prefetch overlaps
// with the merges; at the server's 8-row waves, the instructions of the
// rounds and the merges (each level tests every lane of its right blocks;
// few move), which keep each thread's pointers in registers and unroll
// the levels so that block tests are constants.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kN = snk::kBlock;
constexpr int kHintTile = 1024;
constexpr int kHintShift = 10;
// The tiles the kernels take: 128 << k positions, k = 0..9 (the TPU
// kernels' rule: a multiple of 128 that divides 65536).
constexpr int kMinShift = 7;
constexpr int kMaxShift = 16;
// The row's map (uint16), then its literal bytes (uint8).
constexpr int kSmem = kN * static_cast<int>(sizeof(uint16_t)) + kN;

__host__ __device__ constexpr int bit_length(int v) {
  return v ? 1 + bit_length(v >> 1) : 0;
}

// Rounds that bring a 1024-tile to its local fixed point.
constexpr int kMaxLocal = bit_length(kHintTile);

__device__ __forceinline__ uint32_t pack2(int lo, int hi) {
  return (static_cast<uint32_t>(lo) & 0xffffu) |
         (static_cast<uint32_t>(hi) << 16);
}

// Phase 1: s[p] = src[p] as uint16, 16 bytes a load, eight loads a thread
// in flight.
__device__ __forceinline__ void load_map(const int32_t* __restrict__ S,
                                         uint16_t* s) {
  const int4* S4 = reinterpret_cast<const int4*>(S);
  uint2* s4 = reinterpret_cast<uint2*>(s);
  constexpr int kPer = kN / 4 / kThreads;
  constexpr int kBatch = 8;
#pragma unroll 1
  for (int h = 0; h < kPer; h += kBatch) {
    int4 x[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      x[j] = __ldcs(S4 + threadIdx.x + (h + j) * kThreads);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      s4[threadIdx.x + (h + j) * kThreads] =
          make_uint2(pack2(x[j].x, x[j].y), pack2(x[j].z, x[j].w));
  }
}

// After phase 1: a prefetch of the row's lit into L2, so that lit crosses
// from device memory while the rounds and merges run; load_bytes reads it
// from there before the write.
__device__ __forceinline__ void prefetch_lit(const int32_t* __restrict__ L) {
  constexpr int kLines = kN * 4 / 128;  // lit's 128-byte lines
#pragma unroll
  for (int k = threadIdx.x; k < kLines; k += kThreads)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(L + 32 * k));
}

// Before the write: b[p] = lit[p] as a byte (lit holds bytes), 16 bytes a
// load, from L2 once prefetch_lit has brought the row there. With kFlags,
// in phase 1: b[p] = flags[p] != 0.
template <bool kFlags = false>
__device__ __forceinline__ void load_bytes(const int32_t* __restrict__ L,
                                           uint8_t* b) {
  const int4* L4 = reinterpret_cast<const int4*>(L);
  uint32_t* b4 = reinterpret_cast<uint32_t*>(b);
  constexpr int kPer = kN / 4 / kThreads;
  constexpr int kBatch = 8;
#pragma unroll 1
  for (int h = 0; h < kPer; h += kBatch) {
    int4 y[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      y[j] = __ldcs(L4 + threadIdx.x + (h + j) * kThreads);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      b4[threadIdx.x + (h + j) * kThreads] =
          kFlags ? static_cast<uint32_t>(y[j].x != 0) |
                       static_cast<uint32_t>(y[j].y != 0) << 8 |
                       static_cast<uint32_t>(y[j].z != 0) << 16 |
                       static_cast<uint32_t>(y[j].w != 0) << 24
                 : (static_cast<uint32_t>(y[j].x) & 0xffu) |
                       (static_cast<uint32_t>(y[j].y) & 0xffu) << 8 |
                       (static_cast<uint32_t>(y[j].z) & 0xffu) << 16 |
                       static_cast<uint32_t>(y[j].w) << 24;
  }
}

// Phase 2 at tiles of up to 1024 positions: every tile at once, each on
// one warp with no barrier shared with another tile. A warp holds 2048
// lanes, 2048 / kTile tiles, and runs them one after the other, each with
// synchronous rounds (every lane reads, a warp vote, every lane writes):
// min(max(depths[t], 0), bit_length(kTile)) of them, or `rounds` in every
// tile when depths is null. A round that moves nothing ends the tile's
// loop: it would change nothing. A thread keeps its kTile / 64 pairs of
// lanes in registers across the rounds and writes back the pairs that
// moved.
template <int kTile>
__device__ __forceinline__ void warp_rounds(uint16_t* s,
                                            const int32_t* __restrict__ depths,
                                            int rounds, int warp, int lane) {
  constexpr int kPairs = kTile / 64;
  constexpr int kCap = bit_length(kTile);
  constexpr int kWarpTiles = kN / kTile / kWarps;
  uint32_t* s2 = reinterpret_cast<uint32_t*>(s);
  for (int t = warp * kWarpTiles; t < (warp + 1) * kWarpTiles; ++t) {
    const int base = t * kTile;
    const int count =
        depths != nullptr ? min(max(depths[t], 0), kCap) : rounds;
    if (count == 0) continue;
    uint32_t pr[kPairs];
#pragma unroll
    for (int j = 0; j < kPairs; ++j) pr[j] = s2[base / 2 + lane + 32 * j];
    for (int r = 0; r < count; ++r) {
      uint32_t nv[kPairs];
      int moved = 0;
#pragma unroll
      for (int j = 0; j < kPairs; ++j) {
        const int v0 = pr[j] & 0xffffu, v1 = pr[j] >> 16;
        const int w0 = static_cast<unsigned>(v0 - base) < kTile ? s[v0] : v0;
        const int w1 = static_cast<unsigned>(v1 - base) < kTile ? s[v1] : v1;
        nv[j] = pack2(w0, w1);
        moved |= nv[j] != pr[j];
      }
      // The vote needs every lane's reads done: the round's snapshot.
      if (!__any_sync(~0u, moved)) break;
#pragma unroll
      for (int j = 0; j < kPairs; ++j)
        if (nv[j] != pr[j]) {
          s2[base / 2 + lane + 32 * j] = nv[j];
          pr[j] = nv[j];
        }
      __syncwarp();
    }
  }
}

// Phase 2 at tiles of 2048 positions and more (resolve_tiled_depth only):
// a tile spans kTile / 2048 warps, so the rounds are block-synchronous.
// Pair j of a thread (lanes 2 (threadIdx.x + 1024 j) and the next) lies in
// tile j / (kTile / 2048), the same tile for every thread. The block runs
// the row's largest count of rounds; a tile whose own count is spent only
// waits at the barriers. Every thread reads its pairs, the barrier (whose
// vote ends the loop once no lane of the row moves), then it writes the
// pairs that moved, holding the new values in registers in between: the
// uint16 map leaves no room for a second copy.
template <int kTile>
__device__ __forceinline__ void block_rounds(
    uint16_t* s, const int32_t* __restrict__ depths) {
  constexpr int kTiles = kN / kTile;
  constexpr int kCap = bit_length(kTile);
  constexpr int kPairs = kN / 2 / kThreads;
  constexpr int kPerTile = kTile / 2048;  // pairs j of one tile
  __shared__ int count[kTiles];
  uint32_t* s2 = reinterpret_cast<uint32_t*>(s);
  if (threadIdx.x < kTiles)
    count[threadIdx.x] = min(max(depths[threadIdx.x], 0), kCap);
  __syncthreads();
  int most = 0;
#pragma unroll
  for (int t = 0; t < kTiles; ++t) most = max(most, count[t]);
  for (int r = 0; r < most; ++r) {
    uint32_t nv[kPairs];
    uint32_t moved = 0;
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const int t = j / kPerTile;
      const uint32_t pr = s2[threadIdx.x + j * kThreads];
      nv[j] = pr;
      if (r < count[t]) {
        const int base = t * kTile;
        const int v0 = pr & 0xffffu, v1 = pr >> 16;
        const int w0 = static_cast<unsigned>(v0 - base) < kTile ? s[v0] : v0;
        const int w1 = static_cast<unsigned>(v1 - base) < kTile ? s[v1] : v1;
        nv[j] = pack2(w0, w1);
        if (nv[j] != pr) moved |= 1u << j;
      }
    }
    if (!__syncthreads_or(moved != 0)) break;
#pragma unroll
    for (int j = 0; j < kPairs; ++j)
      if (moved >> j & 1u) s2[threadIdx.x + j * kThreads] = nv[j];
    __syncthreads();
  }
}

// The TPU's `open` test on one pair of lanes (pointers v, flags f0 and f1,
// tile base `base`): some lane points in-tile at a non-root.
__device__ __forceinline__ bool pair_open(uint32_t v, uint32_t f0,
                                          uint32_t f1, int base) {
  return (static_cast<int>(v & 0xffffu) >= base && f0 == 0) ||
         (static_cast<int>(v >> 16) >= base && f1 == 0);
}

// resolve_tiled_flag's phase 2 at tiles of up to 1024 positions: the warp
// form of warp_rounds, with the flags f (bytes, 0 or 1) beside the
// pointers. A thread keeps its pairs' pointers and their flags (bit 2 j +
// u: lane u of pair j) in registers across the rounds. Each round is a
// warp vote on the current state (the TPU's `open`), the round's reads (a
// lane whose pointer v lies in the tile reads s[v] and f[v]), a vote on
// whether a pointer moved, and the writes of what changed: the tile's loop
// ends at the first vote that fails, so a closed tile reads nothing more.
template <int kTile>
__device__ __forceinline__ void warp_flag_rounds(uint16_t* s, uint8_t* f,
                                                 int warp, int lane) {
  constexpr int kPairs = kTile / 64;
  constexpr int kCap = bit_length(kTile);
  constexpr int kWarpTiles = kN / kTile / kWarps;
  static_assert(2 * kPairs <= 32, "a pair's two flags a bit each");
  uint32_t* s2 = reinterpret_cast<uint32_t*>(s);
  uint16_t* f2 = reinterpret_cast<uint16_t*>(f);
  for (int t = warp * kWarpTiles; t < (warp + 1) * kWarpTiles; ++t) {
    const int base = t * kTile;
    uint32_t pr[kPairs];
    uint32_t fb = 0;
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      pr[j] = s2[base / 2 + lane + 32 * j];
      const uint32_t fl = f2[base / 2 + lane + 32 * j];
      fb |= ((fl & 1u) | (fl >> 7 & 2u)) << (2 * j);
    }
    for (int r = 0; r < kCap; ++r) {
      bool open = false;
#pragma unroll
      for (int j = 0; j < kPairs; ++j)
        open |= pair_open(pr[j], fb >> (2 * j) & 1u, fb >> (2 * j + 1) & 1u,
                          base);
      if (!__any_sync(~0u, open)) break;
      uint32_t nv[kPairs];
      uint32_t nf = 0;
      bool moved = false;
#pragma unroll
      for (int j = 0; j < kPairs; ++j) {
        const int v0 = pr[j] & 0xffffu, v1 = pr[j] >> 16;
        const bool in0 = static_cast<unsigned>(v0 - base) < kTile;
        const bool in1 = static_cast<unsigned>(v1 - base) < kTile;
        nv[j] = pack2(in0 ? s[v0] : v0, in1 ? s[v1] : v1);
        const uint32_t g0 = in0 ? f[v0] : fb >> (2 * j) & 1u;
        const uint32_t g1 = in1 ? f[v1] : fb >> (2 * j + 1) & 1u;
        nf |= (g0 | g1 << 1) << (2 * j);
        moved |= nv[j] != pr[j];
      }
      // The vote needs every lane's reads done: the round's snapshot.
      if (!__any_sync(~0u, moved)) break;
#pragma unroll
      for (int j = 0; j < kPairs; ++j) {
        if (nv[j] != pr[j]) {
          s2[base / 2 + lane + 32 * j] = nv[j];
          pr[j] = nv[j];
        }
        if ((nf ^ fb) >> (2 * j) & 3u)
          f2[base / 2 + lane + 32 * j] = static_cast<uint16_t>(
              (nf >> (2 * j) & 1u) | (nf >> (2 * j + 1) & 1u) << 8);
      }
      fb = nf;
      __syncwarp();
    }
  }
}

// One bit a tile, or'ed over the block into *word: a warp reduction, then
// one atomic a warp.
__device__ __forceinline__ void or_vote(uint32_t bits, uint32_t* word) {
  bits = __reduce_or_sync(~0u, bits);
  if ((threadIdx.x & 31) == 0 && bits != 0) atomicOr(word, bits);
}

// resolve_tiled_flag's phase 2 at tiles of 2048 positions and more: a tile
// spans kTile / 2048 warps, so the rounds are block-synchronous, as in
// block_rounds (pair j of a thread lies in tile j / (kTile / 2048)), and
// the votes are one bit a tile in shared memory. `live` holds the tiles
// whose loop goes on: open before the round, and moved by the rounds so
// far. A round: every thread reads its live tiles' pairs and their
// targets, votes `moved`; the barrier; the tiles that moved nothing drop
// out; every thread writes its live tiles' pairs that changed (pointer or
// flag), held in registers (the flags as bits, 2 (j % 16) + u of nf[j /
// 16]), and votes `open` for the next round on those registers; the
// barrier; the tiles not open drop out. A tile whose loop has ended only
// waits at the barriers; the loop ends once none is live. Each word
// alternates by the round's parity, so that thread 0 clears the one the
// next round writes while the others may still read this round's.
template <int kTile>
__device__ __forceinline__ void block_flag_rounds(uint16_t* s, uint8_t* f) {
  constexpr int kCap = bit_length(kTile);
  constexpr int kPairs = kN / 2 / kThreads;
  constexpr int kPerTile = kTile / 2048;  // pairs j of one tile
  // [r & 1]: the tiles open before round r; the tiles round r moved.
  __shared__ uint32_t open_votes[2], moved_votes[2];
  uint32_t* s2 = reinterpret_cast<uint32_t*>(s);
  uint16_t* f2 = reinterpret_cast<uint16_t*>(f);
  if (threadIdx.x < 2) open_votes[threadIdx.x] = moved_votes[threadIdx.x] = 0;
  __syncthreads();
  uint32_t open = 0;
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const int t = j / kPerTile;
    const uint32_t fl = f2[threadIdx.x + j * kThreads];
    if (pair_open(s2[threadIdx.x + j * kThreads], fl & 1u, fl >> 8,
                  t * kTile))
      open |= 1u << t;
  }
  or_vote(open, &open_votes[0]);
  __syncthreads();
  uint32_t live = open_votes[0];
  for (int r = 0; r < kCap && live != 0; ++r) {
    uint32_t nv[kPairs];
    uint32_t nf[2] = {0, 0};
    uint32_t moved = 0, changed = 0;
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const int t = j / kPerTile;
      if (!(live >> t & 1u)) continue;
      const int base = t * kTile;
      const uint32_t pr = s2[threadIdx.x + j * kThreads];
      const uint32_t fl = f2[threadIdx.x + j * kThreads];
      const int v0 = pr & 0xffffu, v1 = pr >> 16;
      const bool in0 = static_cast<unsigned>(v0 - base) < kTile;
      const bool in1 = static_cast<unsigned>(v1 - base) < kTile;
      nv[j] = pack2(in0 ? s[v0] : v0, in1 ? s[v1] : v1);
      const uint32_t g0 = in0 ? f[v0] : fl & 1u;
      const uint32_t g1 = in1 ? f[v1] : fl >> 8;
      nf[j / 16] |= (g0 | g1 << 1) << (2 * (j % 16));
      if (nv[j] != pr) moved |= 1u << t;
      if (nv[j] != pr || (g0 | g1 << 8) != fl) changed |= 1u << j;
    }
    or_vote(moved, &moved_votes[r & 1]);
    __syncthreads();
    live &= moved_votes[r & 1];
    if (live == 0) break;
    if (threadIdx.x == 0) {
      open_votes[r & 1] = 0;
      moved_votes[(r + 1) & 1] = 0;
    }
    open = 0;
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const int t = j / kPerTile;
      if (!(live >> t & 1u)) continue;
      const uint32_t g = nf[j / 16] >> (2 * (j % 16));
      if (changed >> j & 1u) {
        s2[threadIdx.x + j * kThreads] = nv[j];
        f2[threadIdx.x + j * kThreads] =
            static_cast<uint16_t>((g & 1u) | (g & 2u) << 7);
      }
      if (pair_open(nv[j], g & 1u, g >> 1 & 1u, t * kTile)) open |= 1u << t;
    }
    or_vote(open, &open_votes[(r + 1) & 1]);
    __syncthreads();
    live &= open_votes[(r + 1) & 1];
  }
}

// Phases 3 and 4: the absorbs as merges of tile blocks (2^kShift-lane
// tiles), then the write. Lane q is terminal when s[q] >= its tile base;
// every other lane's pointer lies left of its tile. Level k merges pairs
// of 2^k-lane blocks, k from kShift to 15. Invariant after level k: a
// non-terminal lane's pointer is a terminal lane or lies left of the
// lane's 2^(k+1)-lane block. At level k a lane of a right (odd) block
// whose pointer v lies in the block's left sibling reads s[v]; if v is
// terminal it keeps v, else it takes s[v], which by the invariant is a
// terminal lane or lies left of the sibling, the merged block's start.
// Writers lie in right blocks and read only left ones, so a level needs no
// order and no atomics; a block barrier ends it. After the last level
// every non-terminal lane points at a terminal lane, where the walk's
// recursion out[p] = out[v] ends: out[p] = lit[s[v]], and lit[s[p]] for a
// terminal lane. With kRoots (every tile at its local fixed point, so a
// terminal lane points at an in-tile root), a lane takes s[v] whether or
// not v is terminal: its pointer ends at its root, out[p] = lit[s[p]]. The
// write reads lit's bytes from shared memory (load_bytes). Quad i =
// threadIdx.x + 1024 j holds lanes 4 i to 4 i + 3, all in one tile; a
// thread keeps its 16 quads' pointers in registers throughout and writes
// back the quads that moved. Levels and quads are unrolled, so that a
// quad's block, and from 4096-lane blocks up its sibling's start, are
// constants.
template <int kShift, bool kRoots>
__device__ __forceinline__ void merge_and_write(uint16_t* s, uint8_t* b,
                                                const int32_t* __restrict__ L,
                                                int32_t* __restrict__ O) {
  constexpr int kQuads = kN / 4 / kThreads;
  uint2* s4 = reinterpret_cast<uint2*>(s);
  const int t4 = 4 * threadIdx.x;  // quad i's first lane is t4 + 4096 j
  uint2 q[kQuads];
#pragma unroll
  for (int j = 0; j < kQuads; ++j) q[j] = s4[threadIdx.x + j * kThreads];
#pragma unroll
  for (int k = kShift; k < 16; ++k) {
#pragma unroll
    for (int j = 0; j < kQuads; ++j) {
      // An even block has nothing to read; lo: the left sibling's start.
      const bool odd = k >= 12 ? (j >> (k - 12) & 1) : (t4 >> k & 1);
      if (!odd) continue;
      const int lo = k >= 12 ? (4 * kThreads * j) & ~((2 << k) - 1)
                             : 4 * kThreads * j + (t4 & ~((2 << k) - 1));
      int v[4] = {static_cast<int>(q[j].x & 0xffffu),
                  static_cast<int>(q[j].x >> 16),
                  static_cast<int>(q[j].y & 0xffffu),
                  static_cast<int>(q[j].y >> 16)};
      bool moved = false;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (static_cast<unsigned>(v[u] - lo) >= (1u << k)) continue;
        const int w = s[v[u]];
        if (w != v[u] && (kRoots || w < (v[u] >> kShift << kShift))) {
          v[u] = w;
          moved = true;
        }
      }
      if (moved) {
        q[j] = make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
        s4[threadIdx.x + j * kThreads] = q[j];
      }
    }
    __syncthreads();
  }
  load_bytes(L, b);
  __syncthreads();
  int4* O4 = reinterpret_cast<int4*>(O);
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    const int base = (t4 + 4 * kThreads * j) >> kShift << kShift;
    int t[4] = {static_cast<int>(q[j].x & 0xffffu),
                static_cast<int>(q[j].x >> 16),
                static_cast<int>(q[j].y & 0xffffu),
                static_cast<int>(q[j].y >> 16)};
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (!kRoots && t[u] < base) t[u] = s[t[u]];
    __stcs(O4 + threadIdx.x + j * kThreads,
           make_int4(b[t[0]], b[t[1]], b[t[2]], b[t[3]]));
  }
}

// Phase 2 at tile kTile: the warp form up to 1024 positions, the block
// form above.
template <int kTile>
__device__ __forceinline__ void local_rounds(uint16_t* s,
                                             const int32_t* __restrict__ depths,
                                             int rounds) {
  if constexpr (kTile <= kHintTile)
    warp_rounds<kTile>(s, depths, rounds, threadIdx.x >> 5, threadIdx.x & 31);
  else
    block_rounds<kTile>(s, depths);
}

// resolve_tiled at tile 2^kShift. A `resolved` row runs the walk's absorbs
// alone: merges of 2^kShift-tiles on src. Any other row gets
// lit[fix(src)] from the walk at every tile (its rounds bring each tile to
// its local fixed point, and the absorbs compose those), so it takes the
// same bytes by the shorter route: rounds until nothing moves in
// 1024-tiles (at most 11: a chain inside one has fewer than 1024 hops, and
// 10 rounds cover 1024), then merges of 1024-tiles.
template <int kShift>
__global__ void __launch_bounds__(kThreads, 1)
resolve_tail_kernel(const int32_t* __restrict__ lit,
                    const int32_t* __restrict__ src,
                    const uint8_t* __restrict__ resolved,
                    int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* s = reinterpret_cast<uint16_t*>(smem);
  uint8_t* b = smem + kN * sizeof(uint16_t);
  const size_t row = static_cast<size_t>(blockIdx.x) * kN;
  load_map(src + row, s);
  __syncthreads();
  prefetch_lit(lit + row);
  if (resolved != nullptr && resolved[blockIdx.x] != 0) {
    merge_and_write<kShift, false>(s, b, lit + row, out + row);
  } else {
    local_rounds<kHintTile>(s, nullptr, kMaxLocal);
    __syncthreads();
    merge_and_write<kHintShift, true>(s, b, lit + row, out + row);
  }
}

// resolve_tiled_depth at tile 2^kShift: min(max(depths[row, t], 0),
// bit_length(tile)) synchronous rounds in tile t, then merges of tiles.
template <int kShift>
__global__ void __launch_bounds__(kThreads, 1)
resolve_depth_kernel(const int32_t* __restrict__ lit,
                     const int32_t* __restrict__ src,
                     const int32_t* __restrict__ depths,
                     int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* s = reinterpret_cast<uint16_t*>(smem);
  uint8_t* b = smem + kN * sizeof(uint16_t);
  const size_t row = static_cast<size_t>(blockIdx.x) * kN;
  load_map(src + row, s);
  __syncthreads();
  prefetch_lit(lit + row);
  local_rounds<(1 << kShift)>(s, depths + blockIdx.x * (kN >> kShift), 0);
  __syncthreads();
  merge_and_write<kShift, false>(s, b, lit + row, out + row);
}

// Whether some flag of the row is over-approximate: set on a lane whose
// pointer v is not a root (s[v] != v). The flags come from device memory,
// 16 bytes a load, eight loads a thread in flight (each covers the four
// lanes of one of the thread's quads of s); a block vote ends the pass.
__device__ __forceinline__ bool any_over(const uint16_t* s,
                                         const int32_t* __restrict__ F) {
  const uint2* s4 = reinterpret_cast<const uint2*>(s);
  const int4* F4 = reinterpret_cast<const int4*>(F);
  constexpr int kPer = kN / 4 / kThreads;
  constexpr int kBatch = 8;
  int over = 0;
#pragma unroll 1
  for (int h = 0; h < kPer; h += kBatch) {
    int4 y[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      y[j] = __ldcs(F4 + threadIdx.x + (h + j) * kThreads);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const uint2 q = s4[threadIdx.x + (h + j) * kThreads];
      const int v[4] = {static_cast<int>(q.x & 0xffffu),
                        static_cast<int>(q.x >> 16),
                        static_cast<int>(q.y & 0xffffu),
                        static_cast<int>(q.y >> 16)};
      const int fl[4] = {y[j].x, y[j].y, y[j].z, y[j].w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        over |= fl[u] != 0 && s[v[u]] != v[u];
    }
  }
  return __syncthreads_or(over);
}

// resolve_tiled_flag at tile 2^kShift. A row with no over-approximate flag
// (any_over, which reads the flags) takes resolve_tiled's route: a flag of
// 1 then always sits on a lane at a root (a round carries a root's flag to
// a lane whose pointer it sets to that root), so a tile's vote stays open
// while some in-tile pointer is not at a root, and every tile reaches its
// local fixed point within its bit_length(tile) rounds; the walk's bytes
// are then lit[fix(src)] at every tile. Any other row loads its flags as
// bytes where lit's bytes go at the write, runs every tile's flag rounds
// at once, then merges of tiles.
template <int kShift>
__global__ void __launch_bounds__(kThreads, 1)
resolve_flag_kernel(const int32_t* __restrict__ lit,
                    const int32_t* __restrict__ src,
                    const int32_t* __restrict__ flags,
                    int32_t* __restrict__ out) {
  constexpr int kTile = 1 << kShift;
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* s = reinterpret_cast<uint16_t*>(smem);
  uint8_t* b = smem + kN * sizeof(uint16_t);
  const size_t row = static_cast<size_t>(blockIdx.x) * kN;
  load_map(src + row, s);
  __syncthreads();
  if (!any_over(s, flags + row)) {
    prefetch_lit(lit + row);
    local_rounds<kHintTile>(s, nullptr, kMaxLocal);
    __syncthreads();
    merge_and_write<kHintShift, true>(s, b, lit + row, out + row);
    return;
  }
  load_bytes<true>(flags + row, b);
  __syncthreads();
  prefetch_lit(lit + row);
  if constexpr (kTile <= kHintTile)
    warp_flag_rounds<kTile>(s, b, threadIdx.x >> 5, threadIdx.x & 31);
  else
    block_flag_rounds<kTile>(s, b);
  __syncthreads();
  merge_and_write<kShift, false>(s, b, lit + row, out + row);
}

// A kernel template's instance at tile 2^shift, or null for a shift
// outside kMinShift..kMaxShift (the wrappers refuse those tiles first).
template <int kShift = kMinShift>
auto tail_kernel(int shift) -> decltype(&resolve_tail_kernel<kMinShift>) {
  if constexpr (kShift > kMaxShift) {
    return nullptr;
  } else {
    return shift == kShift ? resolve_tail_kernel<kShift>
                           : tail_kernel<kShift + 1>(shift);
  }
}

template <int kShift = kMinShift>
auto depth_kernel(int shift) -> decltype(&resolve_depth_kernel<kMinShift>) {
  if constexpr (kShift > kMaxShift) {
    return nullptr;
  } else {
    return shift == kShift ? resolve_depth_kernel<kShift>
                           : depth_kernel<kShift + 1>(shift);
  }
}

template <int kShift = kMinShift>
auto flag_kernel(int shift) -> decltype(&resolve_flag_kernel<kMinShift>) {
  if constexpr (kShift > kMaxShift) {
    return nullptr;
  } else {
    return shift == kShift ? resolve_flag_kernel<kShift>
                           : flag_kernel<kShift + 1>(shift);
  }
}

// Launch a 1024-thread row kernel with the map and lit in kSmem bytes of
// dynamic shared memory.
template <typename Kernel, typename... Args>
int launch_row_kernel(Kernel kernel, int batch, cudaStream_t stream,
                      Args... args) {
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch, kThreads, kSmem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lit, src, out: (batch, 65536) int32, src 16-byte aligned; resolved:
// (batch,) bool, or null; tile_shift: log2 of the tile (7..16), which only
// the `resolved` rows' merges depend on.
SNK_EXPORT int snk_resolve_tiled(const void* lit, const void* src,
                                 const void* resolved, void* out, int batch,
                                 int tile_shift, void* stream) {
  return launch_row_kernel(
      tail_kernel(tile_shift), batch, static_cast<cudaStream_t>(stream),
      static_cast<const int32_t*>(lit), static_cast<const int32_t*>(src),
      static_cast<const uint8_t*>(resolved), static_cast<int32_t*>(out));
}

// lit, src, out: (batch, 65536) int32, src 16-byte aligned; depths:
// (batch, 65536 >> tile_shift) int32; tile_shift 7..16.
SNK_EXPORT int snk_resolve_tiled_depth(const void* lit, const void* src,
                                       const void* depths, void* out,
                                       int batch, int tile_shift,
                                       void* stream) {
  return launch_row_kernel(
      depth_kernel(tile_shift), batch, static_cast<cudaStream_t>(stream),
      static_cast<const int32_t*>(lit), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(depths), static_cast<int32_t*>(out));
}

// lit, src, flags, out: (batch, 65536) int32, src and flags 16-byte
// aligned; tile_shift 7..16.
SNK_EXPORT int snk_resolve_tiled_flag(const void* lit, const void* src,
                                      const void* flags, void* out, int batch,
                                      int tile_shift, void* stream) {
  return launch_row_kernel(
      flag_kernel(tile_shift), batch, static_cast<cudaStream_t>(stream),
      static_cast<const int32_t*>(lit), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(flags), static_cast<int32_t*>(out));
}
