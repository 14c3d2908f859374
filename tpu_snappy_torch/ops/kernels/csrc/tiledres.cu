// resolve_tiled: out[p] = lit[fix(src)[p]], fix = src iterated to its
// fixed point, for maps with src[p] <= p (copy sources lie behind);
// resolve_tiled_depth, the same walk with a given number of rounds a tile;
// and resolve_tiled_flag, the walk steered by per-lane root flags.
//
// Replaces tpu_snappy/ops/pallas/tiledres.py:resolve_tiled (the "fori"
// variant, with its `resolved` flag), tiledres.py:resolve_tiled_depth and
// tiledres.py:resolve_tiled_flag.
// The TPU kernels walk tiles left to right; in each they run pointer
// doubling inside the tile with one-hot MXU gathers, then absorb one byte
// gather from a plane that holds final bytes for every earlier tile. These
// kernels keep that algorithm, because it is what bounds the work for any
// src with src[p] <= p (a per-lane chase of the period-1 chain would take
// 65535 hops): one block per row keeps the tile's pointers in shared
// memory, doubles them with plain indexed loads, and then reads each
// lane's byte from lit (a position at or right of the tile base, whose
// byte is still its literal) or from the row's own output (an earlier
// tile, already final).
//
// How many doubling rounds a tile runs:
//   * resolve_tiled (tile 4096): at most 13 (bit_length(4096)), stopping
//     after the first round that moves nothing; none at all in a row whose
//     `resolved` flag is set (the caller's proof that src is at its fixed
//     point: the absorb alone is then exact);
//   * resolve_tiled_depth (tile 1024): exactly min(depths[t], 11) rounds,
//     whether or not the tile is then at its local fixed point, so an
//     under-declared depth gives the TPU's own wrong bytes (the framed
//     chunk CRC rejects them). A round that moves nothing leaves the state
//     as it is, so the loop may stop there without changing any byte;
//   * resolve_tiled_flag (tile 4096): a flag f[q] ("my pointer is at a
//     root") rides beside each pointer, and a round moves both, s2 = s[d]
//     and f2 = f[d], from one snapshot. The tile runs rounds while some
//     lane points in-tile with f == 0, at most 13, on the current state;
//     no `moved` break and no `resolved` skip, exactly the TPU's loop
//     (tiledres.py:_make_kernel_flag). Exact flags end each tile after its
//     productive rounds; an over-approximate flag (1 on an unresolved
//     lane) stops a tile early and gives the TPU's own wrong bytes, and
//     all-zero flags run all 13 rounds and stay exact.
//
// Bound on this card: the serial walk. 16 (or 64) tiles x rounds x two
// barriers per row, with one block per row, so a small batch leaves most
// SMs idle; the traffic (lit, src, out: 768 KB per row) is small.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

__host__ __device__ constexpr int bit_length(int v) {
  return v ? 1 + bit_length(v >> 1) : 0;
}

// Absorb: lanes left of the tile read final bytes of earlier tiles, the
// others read lit (what the TPU's byte plane still holds there). Ends with
// a barrier, so the next tile may overwrite s.
template <int kTile>
__device__ __forceinline__ void absorb(const int32_t* s, int base,
                                       const int32_t* L, int32_t* O) {
#pragma unroll
  for (int j = 0; j < kTile / kThreads; ++j) {
    const int q = threadIdx.x + j * kThreads;
    const int v = s[q];
    O[base + q] = v >= base ? L[v] : O[v];
  }
  __syncthreads();
}

// depths == nullptr: up to bit_length(kTile) rounds a tile, none in a row
// with resolved[row] set (resolved may be nullptr). Otherwise
// min(depths[row, t], bit_length(kTile)) rounds in tile t.
template <int kTile>
__global__ void __launch_bounds__(kThreads)
resolve_kernel(const int32_t* __restrict__ lit,
               const int32_t* __restrict__ src,
               const uint8_t* __restrict__ resolved,
               const int32_t* __restrict__ depths, int32_t* out) {
  constexpr int kPer = kTile / kThreads;
  constexpr int kMaxLocal = bit_length(kTile);  // in-tile depth < kTile
  constexpr int kTiles = snk::kBlock / kTile;
  __shared__ int32_t s[kTile];
  const size_t row = static_cast<size_t>(blockIdx.x) * snk::kBlock;
  const int32_t* L = lit + row;
  const int32_t* S = src + row;
  int32_t* O = out + row;
  const bool skip = resolved != nullptr && resolved[blockIdx.x] != 0;
  for (int t = 0; t < kTiles; ++t) {
    const int base = t * kTile;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int q = threadIdx.x + j * kThreads;
      s[q] = S[base + q];
    }
    __syncthreads();
    int rounds = skip ? 0 : kMaxLocal;
    if (depths != nullptr)
      rounds = min(max(depths[blockIdx.x * kTiles + t], 0), kMaxLocal);
    // Local doubling: lanes move to in-tile targets' current pointers.
    for (int r = 0; r < rounds; ++r) {
      int nv[kPer];
      int moved = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int v = s[threadIdx.x + j * kThreads];
        const int d = v - base;
        nv[j] = (d >= 0 && d < kTile) ? s[d] : v;
        moved |= nv[j] != v;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[threadIdx.x + j * kThreads] = nv[j];
      if (!__syncthreads_or(moved)) break;
    }
    absorb<kTile>(s, base, L, O);
  }
}

// Flag variant at tile kTile: f[q] != 0 says s[q] is a root (a fixed point
// of the map). flags: (batch, 65536) int32.
template <int kTile>
__global__ void __launch_bounds__(kThreads)
resolve_flag_kernel(const int32_t* __restrict__ lit,
                    const int32_t* __restrict__ src,
                    const int32_t* __restrict__ flags, int32_t* out) {
  constexpr int kPer = kTile / kThreads;
  constexpr int kMaxLocal = bit_length(kTile);
  constexpr int kTiles = snk::kBlock / kTile;
  __shared__ int32_t s[kTile];
  __shared__ uint8_t f[kTile];
  const size_t row = static_cast<size_t>(blockIdx.x) * snk::kBlock;
  const int32_t* L = lit + row;
  const int32_t* S = src + row;
  const int32_t* F = flags + row;
  int32_t* O = out + row;
  for (int t = 0; t < kTiles; ++t) {
    const int base = t * kTile;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int q = threadIdx.x + j * kThreads;
      s[q] = S[base + q];
      f[q] = F[base + q] != 0;
    }
    for (int r = 0; r < kMaxLocal; ++r) {
      // Each lane tests its own lanes, which it wrote last; the barrier
      // then publishes the state the round reads.
      int open = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int q = threadIdx.x + j * kThreads;
        open |= s[q] >= base && !f[q];
      }
      if (!__syncthreads_or(open)) break;
      int nv[kPer];
      uint8_t nf[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int q = threadIdx.x + j * kThreads;
        const int v = s[q];
        const int d = v - base;
        const bool in = d >= 0 && d < kTile;
        nv[j] = in ? s[d] : v;
        nf[j] = in ? f[d] : f[q];
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int q = threadIdx.x + j * kThreads;
        s[q] = nv[j];
        f[q] = nf[j];
      }
    }
    absorb<kTile>(s, base, L, O);  // each lane reads its own lanes of s
  }
}

constexpr int kTailTile = 4096;
constexpr int kHintTile = 1024;

}  // namespace

// lit, src, out: (batch, 65536) int32; resolved: (batch,) bool, or null.
SNK_EXPORT int snk_resolve_tiled(const void* lit, const void* src,
                                 const void* resolved, void* out, int batch,
                                 void* stream) {
  resolve_kernel<kTailTile><<<batch, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lit), static_cast<const int32_t*>(src),
      static_cast<const uint8_t*>(resolved), nullptr,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// lit, src, out: (batch, 65536) int32; depths: (batch, 64) int32.
SNK_EXPORT int snk_resolve_tiled_depth(const void* lit, const void* src,
                                       const void* depths, void* out,
                                       int batch, void* stream) {
  resolve_kernel<kHintTile><<<batch, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lit), static_cast<const int32_t*>(src),
      nullptr, static_cast<const int32_t*>(depths),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// lit, src, flags, out: (batch, 65536) int32.
SNK_EXPORT int snk_resolve_tiled_flag(const void* lit, const void* src,
                                      const void* flags, void* out, int batch,
                                      void* stream) {
  resolve_flag_kernel<kTailTile><<<batch, kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lit), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(flags), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
