"""One pointer-doubling round with per-tile stability flags.

Port of tpu_snappy/ops/pallas/doubling.py:doubling_round, the round of the
decoder's resolve="stable": (s o s, stable') per row, where a tile of
TILE_SIZE positions flagged stable is copied through with its flag kept at
1, and any other tile's new flag is 1 iff none of its lanes changed. The
CUDA kernel is csrc/doubling.cu, on gather_block's load schedule: a block
a (tile, row), four targets a thread with one 16-byte load of s, four
independent table loads and one 16-byte store, the flag read once a
block and a barrier-or for the new one (see its note). A pointer outside
[0, 65536) reads 0, as the TPU's one-hot gather gives.
"""

from __future__ import annotations

import torch

from . import _build

N = 1 << 16
SOURCE = "tpu_snappy_torch/ops/kernels/csrc/doubling.cu"
REPLACES = "tpu_snappy/ops/pallas/doubling.py:73"

#: Positions per stability flag (doubling.py:32: TR x TC).
TILE_SIZE = 1024
#: Flags per row (doubling.py:33).
TILES = N // TILE_SIZE


def doubling_round_plain(s: torch.Tensor, stable: torch.Tensor):
    """Plain PyTorch form: one gather for the whole batch, then the tiles
    flagged stable are put back."""
    b = s.shape[0]
    inside = (s >= 0) & (s < N)
    hop = torch.gather(s, -1, torch.clamp(s, 0, N - 1).long())
    s2 = torch.where(inside, hop, 0).view(b, TILES, TILE_SIZE)
    old = s.view(b, TILES, TILE_SIZE)
    keep = stable != 0
    out = torch.where(keep[..., None], old, s2).reshape(b, N)
    moved = (s2 != old).any(dim=-1)
    return out, torch.where(keep | ~moved, 1, 0).to(torch.int32)


def doubling_round(s: torch.Tensor, stable: torch.Tensor):
    """One round on (B, 65536) int32 maps `s` with (B, 64) int32 flags
    `stable` (zeros at first). Returns (out (B, 65536) int32, stable' (B,
    64) int32). CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if _build.on_cpu(s, stable):
        return doubling_round_plain(s, stable)
    batch = s.shape[0]
    _build.require(s, torch.int32, (batch, N), "s")
    _build.require(stable, torch.int32, (batch, TILES), "stable")
    _build.require_aligned("doubling_round", s, stable)
    out = torch.empty_like(s)
    st = torch.empty_like(stable)
    if batch:
        rc = _build.lib().snk_doubling_round(
            s.data_ptr(), stable.data_ptr(), out.data_ptr(), st.data_ptr(),
            batch, _build.stream())
        _build.check(rc, "doubling_round")
        doubling_round.launches += 1
    return out, st


doubling_round.launches = 0
