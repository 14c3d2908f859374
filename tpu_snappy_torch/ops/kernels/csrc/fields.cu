// elem_fields_block: the speculative element fields of every compressed
// byte, decoded as if it were a tag: size, outbytes, is_lit, hdr, offset,
// each an int32 plane. The four look-ahead bytes wrap at the row's width.
//
// Replaces tpu_snappy/ops/pallas/fields.py:elem_fields_block. The TPU
// kernel tiles a fragment over a grid of 2048-byte steps and feeds each
// step its own tile and an 8-row halo of the next one, rolling lanes and
// sublanes to build the shifted byte streams. Here one thread takes one
// byte position and reads its five bytes directly (through L1; the wrap is
// one compare), so there are no tiles, halos or rolls.
//
// Int32 arithmetic wraps as in JAX: the fields are computed in uint32 and
// cast, since a signed shift or add that overflows is undefined in C++
// (b4 << 24 of a byte >= 128, lit_len of a 4-byte length 0xFFFFFFFF).
//
// Bound on this card: bytes. One byte in, twenty out a position: at the
// decoder's (128, 57344) wave 7.3 MB read and 147 MB written.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fields_kernel(const uint8_t* __restrict__ c, int32_t* __restrict__ out,
              int w, size_t plane) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= w) return;
  const size_t row = static_cast<size_t>(blockIdx.y) * w;
  const uint8_t* C = c + row;
  uint32_t b[5];
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    int j = i + s;
    if (j >= w) j -= w;
    b[s] = __ldg(C + j);
  }
  const uint32_t t = b[0];
  const uint32_t kind = t & 3u;
  const uint32_t code = t >> 2;
  const uint32_t two = b[1] | (b[2] << 8);
  const uint32_t three = two | (b[3] << 16);
  const uint32_t four = three | (b[4] << 24);

  // Literal: 0 to 4 extra length bytes after the tag (code 60 to 63).
  const uint32_t extra = code >= 60u ? code - 59u : 0u;
  const uint32_t ext_val = extra == 0u   ? code
                           : extra == 1u ? b[1]
                           : extra == 2u ? two
                           : extra == 3u ? three
                                         : four;
  const uint32_t lit_len = ext_val + 1u;
  const uint32_t lit_hdr = 1u + extra;
  const uint32_t lit_size = lit_hdr + lit_len;

  // Copies with 1, 2 and 4 offset bytes; a literal's offset is the
  // 4-byte form, as in the TPU kernel.
  const uint32_t copy_len = kind == 1u ? ((t >> 2) & 7u) + 4u : code + 1u;
  const uint32_t copy_size = kind == 1u ? 2u : kind == 2u ? 3u : 5u;
  const uint32_t copy_off = kind == 1u   ? ((t >> 5) << 8) | b[1]
                            : kind == 2u ? two
                                         : four;

  const bool is_lit = kind == 0u;
  int32_t* O = out + row + i;
  O[0] = static_cast<int32_t>(is_lit ? lit_size : copy_size);
  O[plane] = static_cast<int32_t>(is_lit ? lit_len : copy_len);
  O[2 * plane] = is_lit ? 1 : 0;
  O[3 * plane] = static_cast<int32_t>(is_lit ? lit_hdr : copy_size);
  O[4 * plane] = static_cast<int32_t>(copy_off);
}

}  // namespace

// c: (batch, w) uint8; out: (5, batch, w) int32, the planes size,
// outbytes, is_lit, hdr, offset.
SNK_EXPORT int snk_elem_fields(const void* c, void* out, int w, int batch,
                               void* stream) {
  dim3 grid((w + kThreads - 1) / kThreads, batch);
  fields_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(c), static_cast<int32_t*>(out), w,
      static_cast<size_t>(batch) * w);
  return static_cast<int>(cudaGetLastError());
}
