"""Whole-row prefix scans: the inclusive int32 cumsum and the
next-set-position scan.

Port of tpu_snappy/ops/pallas/scans.py:cumsum_block and
next_start_block. The CUDA kernels are csrc/scans.cu (see its note): the
cumsum walks each row with one block in tiles of 4096 and a carry;
next_start_block splits each row into SPAN-position spans, one block a
span, each finding the first set flag right of its span by reading ahead
(AHEAD flags, then steps of 4 spans) instead of waiting for its
neighbour. As in the JAX
package, no codec path runs them: scan.exclusive_cumsum and
scan.next_element_start keep their plain PyTorch forms, the counterparts
of the XLA scans the JAX codec keeps (scans.py:9-16 records the Pallas
forms as a wash). The wrappers are batched: (M,) or (B, M), M a multiple
of 128 (the TPU kernels' (rows, 128) reshape).

next_start_block computes what the TPU kernel computes, which is not
quite scan.next_element_start: `default` is min-reduced into every
position, so the result is min(default, smallest j > i with flags[j]).
The two agree whenever default >= m - 1 (every codec caller passes N).
"""

from __future__ import annotations

import torch

from . import _build

SOURCE = "tpu_snappy_torch/ops/kernels/csrc/scans.cu"
REPLACES = {"cumsum_block": "tpu_snappy/ops/pallas/scans.py:80",
            "next_start_block": "tpu_snappy/ops/pallas/scans.py:116"}

#: Row widths the kernels take are multiples of this (scans.py:34).
LANES = 128

#: next_start_block's kernel: positions a block (kSpan in csrc/scans.cu),
#: and flags its warp 0 reads past the span's end (kAhead). The tests'
#: edge rows put single flags around multiples of both.
SPAN = 4096
AHEAD = 512

_I32_MAX = torch.iinfo(torch.int32).max


def _rows(t: torch.Tensor, name: str) -> torch.Tensor:
    """t as (B, M): raises ValueError unless it is (M,) or (B, M) with M a
    multiple of LANES."""
    if t.dim() not in (1, 2) or t.shape[-1] % LANES:
        raise ValueError(f"{name}: expected (M,) or (B, M) with M a multiple "
                         f"of {LANES}, got {tuple(t.shape)}")
    return t if t.dim() == 2 else t[None]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and 16-byte aligned (the kernels load rows in 16-byte
    words)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_default(default: int) -> None:
    if not -(1 << 31) <= default < 1 << 31:
        raise ValueError(f"next_start_block: default {default} is not an "
                         "int32")


def cumsum_block_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch form: the inclusive prefix sum along the last axis as
    int32, wrapping as int32 arithmetic does (summed in int64, then
    wrapped explicitly)."""
    _rows(x, "cumsum_block")
    s = torch.cumsum(x.to(torch.int32).to(torch.int64), dim=-1)
    s = s & 0xFFFFFFFF
    return torch.where(s >= 1 << 31, s - (1 << 32), s).to(torch.int32)


def cumsum_block(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sum of (M,) or (B, M) `x` along the last axis
    (cast to int32 first; sums wrap as int32). Callers derive the
    exclusive form as `inc - x`. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    rows = _rows(x, "cumsum_block")
    if _build.on_cpu(x):
        return cumsum_block_plain(x)
    rows = _aligned(rows.to(torch.int32))
    out = torch.empty_like(rows)
    if rows.numel():
        rc = _build.lib().snk_cumsum(rows.data_ptr(), out.data_ptr(),
                                     rows.shape[1], rows.shape[0],
                                     _build.stream())
        _build.check(rc, "cumsum_block")
        cumsum_block.launches += 1
    return out.reshape(x.shape)


cumsum_block.launches = 0


def next_start_block_plain(flags: torch.Tensor, default: int) -> torch.Tensor:
    """Plain PyTorch form: int32 min(default, smallest j > i with
    flags[j] != 0) along the last axis."""
    _rows(flags, "next_start_block")
    _check_default(default)
    m = flags.shape[-1]
    iota = torch.arange(m, dtype=torch.int32, device=flags.device)
    at = torch.where(flags != 0, iota, _I32_MAX)
    suffix = torch.flip(torch.cummin(torch.flip(at, [-1]), dim=-1).values,
                        [-1])
    after = torch.roll(suffix, -1, dims=-1)
    after[..., -1] = _I32_MAX
    return torch.clamp(after, max=default).to(torch.int32)


def next_start_block(flags: torch.Tensor, default: int) -> torch.Tensor:
    """For (M,) or (B, M) `flags` (nonzero = set): int32 min(default,
    smallest j > i with flags[j]) along the last axis. CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    rows = _rows(flags, "next_start_block")
    _check_default(default)
    if _build.on_cpu(flags):
        return next_start_block_plain(flags, default)
    if rows.dtype in (torch.bool, torch.int8):
        rows = rows.view(torch.uint8)
    elif rows.dtype != torch.uint8:
        rows = (rows != 0).view(torch.uint8)
    rows = _aligned(rows)
    out = torch.empty(rows.shape, dtype=torch.int32, device=rows.device)
    if rows.numel():
        rc = _build.lib().snk_next_start(rows.data_ptr(), out.data_ptr(),
                                         rows.shape[1], int(default),
                                         rows.shape[0], _build.stream())
        _build.check(rc, "next_start_block")
        next_start_block.launches += 1
    return out.reshape(flags.shape)


next_start_block.launches = 0
