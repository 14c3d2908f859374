"""One in-tile pointer-doubling round over every tile at once.

Port of tpu_snappy/ops/pallas/localround.py:local_round, the parallel
local rounds of the decoder's resolve="paratail": out[p] = src[src[p]]
where src[p] lies in p's own tile, else src[p]. The CUDA kernel is
csrc/localround.cu: one block per (row, tile) snapshots the tile in shared
memory and each lane does one indexed read (no tile-diagonal one-hot; see
its note). `src[p] <= p` must hold, as decode guarantees; the TPU kernel
assumes it too (an in-tile source lies at or left of p).
"""

from __future__ import annotations

import torch

from . import _build

N = 1 << 16
SOURCE = "tpu_snappy_torch/ops/kernels/csrc/localround.cu"
REPLACES = "tpu_snappy/ops/pallas/localround.py:74"

#: The one tile the kernel takes (localround.py:34, the decoder's
#: PARA_TILE).
TILE = 4096


def _check_tile(tile: int) -> None:
    if tile != TILE:
        raise ValueError(f"local_round: tile {tile}; the port takes {TILE} "
                         "only (the decoder's PARA_TILE)")


def local_round_plain(src: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """Plain PyTorch form: all tiles of all rows in one gather."""
    _check_tile(tile)
    s = src.reshape(src.shape[0], N // tile, tile)
    base = (torch.arange(N // tile, dtype=torch.int32, device=src.device)
            * tile)[None, :, None]
    d = s - base
    hop = torch.gather(s, -1, torch.clamp(d, 0, tile - 1).long())
    return torch.where((d >= 0) & (d < tile), hop, s).reshape(src.shape)


def local_round(src: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """One synchronous in-tile doubling round of (B, 65536) int32 maps with
    src[p] <= p, at tile 4096 (any other tile raises ValueError). Returns
    (B, 65536) int32. CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    _check_tile(tile)
    if _build.on_cpu(src):
        return local_round_plain(src, tile)
    batch = src.shape[0]
    _build.require(src, torch.int32, (batch, N), "src")
    out = torch.empty_like(src)
    if batch:
        rc = _build.lib().snk_local_round(src.data_ptr(), out.data_ptr(),
                                          batch, _build.stream())
        _build.check(rc, "local_round")
        local_round.launches += 1
    return out


local_round.launches = 0
