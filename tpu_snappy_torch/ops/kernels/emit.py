"""Emission of the committed parse: (dest << 8 | byte) packs per position.

Port of tpu_snappy/ops/pallas/emit.py: `emit_block_single` (the Pallas
`_single_kernel`) and `emit_block` (the two-lane `_kernel`). The CUDA
kernels are csrc/emit.cu, one template for both. On this card one block
walking a whole row was latency-bound (128 blocks at B = 128, a chain of
dependent chunk steps each) and wrote a row-sized run-length scratch; now
a row is cut into tiles of TILE positions: a summary launch writes
each tile's first element starts (and resets the look-back state), then
one block a tile takes its output offset and literal-base carry from the
earlier tiles by a decoupled look-back and writes every pack once (see the
source note). The scratch is `scratch_ints(batch)` int32, not a row.
The plain single-lane version below is the torch form of
`_single_kernel`; the plain two-lane version is the encoder's XLA
emission lanes (encode._emit_lanes), which the JAX suite proves
bit-identical to `_kernel` (tests/test_fuzz.py:104-123).

Two-lane emission: lane A carries every tag byte (a header's 2nd and 3rd
bytes ride positions i+1 and i+2), lane B the literal payload; an idle
position's dest is SENT.

Single-lane byte-to-position assignment (conflict-free for any committed
parse with jumps in [1, 64]): literal payload rides its own position; a
copy's 2-3 header bytes ride its first positions; a literal run's 1-byte
tag rides position s-1 (the last position of the preceding copy); a run's
2nd and 3rd header bytes go to the sparse overflow arrays `pb` and `pa`
(nonzero only at run starts); a block-opening literal's tag lands in
`head`.
Every pack is below 2^29, so int32 holds it.
"""

from __future__ import annotations

import torch

from ... import format as fmt
from . import _build

N = 1 << 16
SOURCE = "tpu_snappy_torch/ops/kernels/csrc/emit.cu"
REPLACES = {"emit_block_single": "tpu_snappy/ops/pallas/emit.py:305",
            "emit_block": "tpu_snappy/ops/pallas/emit.py:155"}

#: Inactive-destination sentinel (emit.py:36, place.py:38).
SENT = 1 << 20
#: Width of `head` (one row of the TPU kernel's (8, 128) output block).
HEAD = 128
#: Positions a block of the kernel emits (csrc/emit.cu: kTile, 8 a thread).
TILE = 2048


def scratch_ints(batch: int) -> int:
    """int32 entries of the kernels' scratch: per row and tile a look-back
    status word (two int32) and a summary pair, then one ticket counter.
    The kernels reset it themselves (no memset)."""
    return 4 * (N // TILE) * batch + 1


def _rollz(x: torch.Tensor, s: int) -> torch.Tensor:
    """y[i] = x[i - s], 0 for i < s."""
    y = torch.roll(x, s, dims=-1)
    y[..., :s] = 0
    return y


def _rollbz(x: torch.Tensor, s: int) -> torch.Tensor:
    """y[i] = x[i + s], 0 for i >= N - s."""
    y = torch.roll(x, -s, dims=-1)
    y[..., -s:] = 0
    return y


def emit_block_single_plain(cj: torch.Tensor, off: torch.Tensor,
                            block: torch.Tensor, n: torch.Tensor):
    """Plain PyTorch form: (pm, pa, pb (B, N) int32, head (B, 128) int32,
    total (B,) int32)."""
    b = cj.shape[0]
    iota = torch.arange(N, dtype=torch.int32, device=cj.device)
    nn = n.to(torch.int32)[:, None]
    is_copy = cj >= 4
    is_lit = (cj >= 0) & (cj < 4)
    lit_start = is_lit & ~_rollz(is_lit, 1)
    elem = is_copy | lit_start

    # run_end: the smallest element start > i, capped at n.
    eidx = torch.where(elem, iota, N)
    sm = torch.flip(torch.cummin(torch.flip(eidx, [-1]), dim=-1).values,
                    [-1])
    after = torch.roll(sm, -1, dims=-1)
    after[..., -1] = N
    lit_len = torch.clamp(torch.minimum(after, nn) - iota, min=1)

    copy_small = (cj <= fmt.COPY1_MAX_LEN) & (off < fmt.COPY1_MAX_OFFSET)
    copy_sz = torch.where(copy_small, 2, 3)
    lit_hdr = torch.where(lit_len <= 60, 1, torch.where(lit_len <= 256, 2, 3))
    esz = torch.where(elem, torch.where(is_copy, copy_sz, lit_hdr + lit_len),
                      0).to(torch.int32)
    inc = torch.cumsum(esz, dim=-1, dtype=torch.int32)
    out_off = inc - esz
    total = inc[:, -1].contiguous()

    n1 = lit_len - 1
    lt0 = torch.where(lit_len <= 60, n1 << 2,
                      torch.where(lit_len <= 256, 60 << 2, 61 << 2))
    ct0 = torch.where(copy_small, 1 | ((cj - 4) << 2) | ((off >> 8) << 5),
                      2 | ((cj - 1) << 2))
    t12 = torch.where(is_copy, off, n1)
    t1 = t12 & 0xFF
    t2 = (t12 >> 8) & 0xFF

    # Literal payload base, filled forward from each run start.
    idx = torch.arange(N, dtype=torch.int64, device=cj.device).expand(b, N)
    last = torch.where(lit_start, idx, -1).cummax(dim=-1).values
    base = (out_off + lit_hdr - iota).to(torch.int32)
    v = torch.gather(base, -1, torch.where(last >= 0, last, idx))
    payload_dst = v + iota

    c1 = _rollz(is_copy, 1)
    c2v = _rollz(is_copy, 2) & (_rollz(copy_sz, 2) == 3)
    lt0c = _rollbz(lit_start, 1)
    md = torch.where(is_lit, payload_dst,
         torch.where(is_copy, out_off,
         torch.where(c1, _rollz(out_off, 1) + 1,
         torch.where(c2v, _rollz(out_off, 2) + 2,
         torch.where(lt0c, _rollbz(out_off, 1), SENT)))))
    mv = torch.where(is_lit, block.to(torch.int32),
         torch.where(is_copy, ct0,
         torch.where(c1, _rollz(t1, 1),
         torch.where(c2v, _rollz(t2, 2),
         torch.where(lt0c, _rollbz(lt0, 1), 0)))))
    pm = ((md << 8) | (mv & 0xFF)).to(torch.int32)

    pa = torch.where(lit_start & (lit_hdr == 3),
                     ((out_off + 2) << 8) | t2, 0).to(torch.int32)
    pb = torch.where(lit_start & (lit_hdr >= 2),
                     ((out_off + 1) << 8) | t1, 0).to(torch.int32)
    head = torch.full((b, HEAD), SENT << 8, dtype=torch.int32,
                      device=cj.device)
    head[:, 0] = torch.where(lit_start[:, 0], lt0[:, 0] & 0xFF, SENT << 8)
    return pm, pa, pb, head, total


def emit_block_single(cj: torch.Tensor, off: torch.Tensor,
                      block: torch.Tensor, n: torch.Tensor):
    """Single-lane emission of (B, N) int32 `cj` (committed ? jump : -1),
    (B, N) int32 offsets, (B, N) uint8 bytes and (B,) int32 lengths.
    Returns (pm, pa, pb (B, N) int32 packs, head (B, 128) int32, total (B,)
    int32 output sizes). CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if _build.on_cpu(cj, off, block, n):
        return emit_block_single_plain(cj, off, block, n)
    batch = cj.shape[0]
    _build.require(cj, torch.int32, (batch, N), "cj")
    _build.require(off, torch.int32, (batch, N), "off")
    _build.require(block, torch.uint8, (batch, N), "block")
    _build.require(n, torch.int32, (batch,), "n")
    _build.require_aligned("emit_block_single", cj, off, block)
    dev = cj.device
    pm = torch.empty((batch, N), dtype=torch.int32, device=dev)
    pa = torch.empty_like(pm)
    pb = torch.empty_like(pm)
    scratch = torch.empty(scratch_ints(batch), dtype=torch.int32,
                          device=dev)
    head = torch.empty((batch, HEAD), dtype=torch.int32, device=dev)
    total = torch.empty((batch,), dtype=torch.int32, device=dev)
    if batch:
        rc = _build.lib().snk_emit_single(
            cj.data_ptr(), off.data_ptr(), block.data_ptr(), n.data_ptr(),
            scratch.data_ptr(), pm.data_ptr(), pa.data_ptr(), pb.data_ptr(),
            head.data_ptr(), total.data_ptr(), batch, _build.stream())
        _build.check(rc, "emit_block_single")
        emit_block_single.launches += 1
    return pm, pa, pb, head, total


emit_block_single.launches = 0


def emit_block_plain(cj: torch.Tensor, off: torch.Tensor,
                     block: torch.Tensor, n: torch.Tensor):
    """Plain PyTorch form of emit_block: (pack_a, pack_b (B, N) int32,
    total (B,) int32)."""
    from .. import encode  # the XLA emission lanes are the plain body
    return encode._emit_lanes(cj, off, block, n)


def emit_block(cj: torch.Tensor, off: torch.Tensor, block: torch.Tensor,
               n: torch.Tensor):
    """Two-lane emission of (B, N) int32 `cj` (committed ? jump : -1),
    (B, N) int32 offsets, (B, N) uint8 bytes and (B,) int32 lengths.
    Returns (pack_a, pack_b (B, N) int32, total (B,) int32 output sizes).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if _build.on_cpu(cj, off, block, n):
        return emit_block_plain(cj, off, block, n)
    batch = cj.shape[0]
    _build.require(cj, torch.int32, (batch, N), "cj")
    _build.require(off, torch.int32, (batch, N), "off")
    _build.require(block, torch.uint8, (batch, N), "block")
    _build.require(n, torch.int32, (batch,), "n")
    _build.require_aligned("emit_block", cj, off, block)
    pack_a = torch.empty((batch, N), dtype=torch.int32, device=cj.device)
    pack_b = torch.empty_like(pack_a)
    scratch = torch.empty(scratch_ints(batch), dtype=torch.int32,
                          device=cj.device)
    total = torch.empty((batch,), dtype=torch.int32, device=cj.device)
    if batch:
        rc = _build.lib().snk_emit_two_lane(
            cj.data_ptr(), off.data_ptr(), block.data_ptr(), n.data_ptr(),
            scratch.data_ptr(), pack_a.data_ptr(), pack_b.data_ptr(),
            total.data_ptr(), batch, _build.stream())
        _build.check(rc, "emit_block")
        emit_block.launches += 1
    return pack_a, pack_b, total


emit_block.launches = 0
