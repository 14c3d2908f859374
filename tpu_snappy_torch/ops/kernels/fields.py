"""Speculative per-byte element fields: each compressed byte decoded as if
it were a tag.

Port of tpu_snappy/ops/pallas/fields.py:elem_fields_block, the decoder's
fields="kernel". The CUDA kernel is csrc/fields.cu: one thread per byte
position, five byte reads, five int32 planes written (no tiles or halo
views; see its note). The four look-ahead bytes wrap at the row's own
width, like torch.roll and jnp.roll. The plain version is also the
decoder's fields="auto" arithmetic (decode.py's _elem_fields); int32
arithmetic wraps as in JAX.
"""

from __future__ import annotations

import torch

from . import _build

SOURCE = "tpu_snappy_torch/ops/kernels/csrc/fields.cu"
REPLACES = "tpu_snappy/ops/pallas/fields.py:89"

#: Widths the kernel takes are multiples of this (the TPU kernel's
#: 16 x 128 grid step, fields.py:33).
WIDTH_STEP = 2048


def elem_fields_block_plain(c: torch.Tensor):
    """Plain PyTorch form: (size, outbytes, is_lit, hdr, offset) of (B, W)
    uint8 `c`, each (B, W) int32 (is_lit 0 or 1)."""
    t = c.to(torch.int32)
    b1, b2, b3, b4 = (torch.roll(t, -s, dims=-1) for s in (1, 2, 3, 4))
    kind = t & 3
    code = t >> 2

    extra = torch.clamp(code - 59, 0, 4)
    ext_val = torch.where(
        extra == 0, code,
        torch.where(extra == 1, b1,
                    torch.where(extra == 2, b1 | (b2 << 8),
                                torch.where(extra == 3,
                                            b1 | (b2 << 8) | (b3 << 16),
                                            b1 | (b2 << 8) | (b3 << 16)
                                            | (b4 << 24)))))
    lit_len = ext_val + 1
    lit_hdr = 1 + extra
    lit_size = lit_hdr + lit_len

    copy_len = torch.where(kind == 1, ((t >> 2) & 7) + 4, code + 1)
    copy_size = torch.where(kind == 1, 2, torch.where(kind == 2, 3, 5))
    copy_off = torch.where(
        kind == 1, ((t >> 5) << 8) | b1,
        torch.where(kind == 2, b1 | (b2 << 8),
                    b1 | (b2 << 8) | (b3 << 16) | (b4 << 24)))

    is_lit = kind == 0
    size = torch.where(is_lit, lit_size, copy_size).to(torch.int32)
    outbytes = torch.where(is_lit, lit_len, copy_len).to(torch.int32)
    hdr = torch.where(is_lit, lit_hdr, copy_size).to(torch.int32)
    return size, outbytes, is_lit.to(torch.int32), hdr, copy_off


def elem_fields_block(c: torch.Tensor):
    """Element fields of (B, W) uint8 fragments, W a multiple of 2048 (any
    other width raises ValueError). Returns (size, outbytes, is_lit, hdr,
    offset), each (B, W) int32. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    w = c.shape[-1]
    if w % WIDTH_STEP:
        raise ValueError(f"elem_fields_block: width {w} is not a multiple "
                         f"of {WIDTH_STEP}")
    if _build.on_cpu(c):
        return elem_fields_block_plain(c)
    batch = c.shape[0]
    _build.require(c, torch.uint8, (batch, w), "c")
    outs = torch.empty((5, batch, w), dtype=torch.int32, device=c.device)
    if batch and w:
        rc = _build.lib().snk_elem_fields(c.data_ptr(), outs.data_ptr(), w,
                                          batch, _build.stream())
        _build.check(rc, "elem_fields_block")
        elem_fields_block.launches += 1
    return tuple(outs.unbind(0))


elem_fields_block.launches = 0
