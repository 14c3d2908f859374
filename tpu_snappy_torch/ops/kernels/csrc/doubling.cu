// doubling_round: one pointer-doubling round s -> s o s with per-tile
// stability flags, for (batch, 65536) maps in [0, 65536) and (batch, 64)
// flags, one per 1024-position tile.
//
// Replaces tpu_snappy/ops/pallas/doubling.py:doubling_round, the round of
// the decoder's resolve="stable". A tile flagged stable (nonzero) is
// copied through and keeps flag 1; in any other tile every target reads
// out[p] = s[s[p]], and the tile's new flag is 1 iff no lane of it changed
// (its pointers all sit at fixed points, which never move again). The TPU
// kernel skips a stable tile's one-hot MXU gather; here the skip saves the
// tile's table loads.
//
// Bound on this card: bytes (one read of s, one write of out per target;
// the gathered reads are random within the row and served by L2). What
// limits the round is loads in flight, so it runs on gather_block's
// schedule (csrc/gather.cu), the dense round's s[s[p]] over the same
// maps: one 256-thread block per (tile, row), the grid (64, batch) with
// the tile fastest, so the rows run nearly in order and the tables of the
// rows in flight (256 KB each) stay in the 50 MB L2. A thread serves four
// consecutive targets: one 16-byte load of s, four independent table
// loads from the row in device memory, one 16-byte store. The tile's flag
// is read once, by thread 0 into shared memory, while the loads of s are
// in flight; a flagged tile stores the s it loaded (a 4 KB copy, no table
// read) and any other tile's new flag comes from __syncthreads_or. A
// pointer outside [0, 65536) reads 0, as the TPU's one-hot gives.
#include "common.cuh"

namespace {

constexpr int kTileSize = 1024;
constexpr int kTiles = snk::kBlock / kTileSize;
constexpr int kThreads = kTileSize / 4;  // four targets a thread

__global__ void __launch_bounds__(kThreads)
doubling_kernel(const int32_t* __restrict__ s,
                const int32_t* __restrict__ stable, int32_t* __restrict__ out,
                int32_t* __restrict__ stable_out) {
  __shared__ int flagged;
  const size_t row = blockIdx.y;
  const size_t flag = row * kTiles + blockIdx.x;
  const size_t q = (row * snk::kBlock + blockIdx.x * kTileSize) / 4
                 + threadIdx.x;
  const int4 v = __ldg(reinterpret_cast<const int4*>(s) + q);
  if (threadIdx.x == 0) flagged = __ldg(stable + flag);
  __syncthreads();
  int4* o4 = reinterpret_cast<int4*>(out) + q;
  if (flagged != 0) {  // the same for the whole block
    *o4 = v;
    if (threadIdx.x == 0) stable_out[flag] = 1;
    return;
  }
  const int32_t* sr = s + row * snk::kBlock;
  const uint32_t all = 0xffffffffu;
  const int4 w = make_int4(snk::take(sr, snk::kBlock, v.x, all),
                           snk::take(sr, snk::kBlock, v.y, all),
                           snk::take(sr, snk::kBlock, v.z, all),
                           snk::take(sr, snk::kBlock, v.w, all));
  *o4 = w;
  const int moved = __syncthreads_or(w.x != v.x || w.y != v.y
                                     || w.z != v.z || w.w != v.w);
  if (threadIdx.x == 0) stable_out[flag] = moved ? 0 : 1;
}

}  // namespace

// s, out: (batch, 65536) int32, 16-byte aligned; stable, stable_out:
// (batch, 64) int32.
SNK_EXPORT int snk_doubling_round(const void* s, const void* stable, void* out,
                                  void* stable_out, int batch, void* stream) {
  dim3 grid(kTiles, batch);
  doubling_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(s), static_cast<const int32_t*>(stable),
      static_cast<int32_t*>(out), static_cast<int32_t*>(stable_out));
  return static_cast<int>(cudaGetLastError());
}
