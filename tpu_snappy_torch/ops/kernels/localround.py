"""One in-tile pointer-doubling round over every tile at once.

Port of tpu_snappy/ops/pallas/localround.py:local_round, the parallel
local rounds of the decoder's resolve="paratail": out[p] = src[src[p]]
where src[p] lies in p's own tile, else src[p], at every tile the TPU
kernel takes (TILES). The CUDA kernel is csrc/localround.cu: one block
per (row, 4096-position chunk) snapshots the chunk in shared memory and
each lane does one indexed read (no tile-diagonal one-hot; see its
note). `src[p] <= p` must hold, as decode guarantees; the TPU kernel
assumes it too (an in-tile source lies at or left of p).
"""

from __future__ import annotations

import torch

from . import _build

N = 1 << 16
SOURCE = "tpu_snappy_torch/ops/kernels/csrc/localround.cu"
REPLACES = "tpu_snappy/ops/pallas/localround.py:74"

#: The default tile (localround.py:34, the decoder's PARA_TILE).
TILE = 4096
#: Every tile the kernel takes: the TPU kernel's rule, a multiple of 128
#: that divides 65536.
TILES = tuple(128 << k for k in range(10))


def check_tile(name: str, tile: int) -> int:
    """Raise ValueError unless `tile` is one of TILES (the TPU kernels
    assert the same rule). Returns its log2, the CUDA entry points'
    argument."""
    if tile not in TILES:
        raise ValueError(f"{name}: tile {tile}; one of {TILES}")
    return tile.bit_length() - 1


def local_round_plain(src: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """Plain PyTorch form: all tiles of all rows in one gather."""
    check_tile("local_round", tile)
    s = src.reshape(src.shape[0], N // tile, tile)
    base = (torch.arange(N // tile, dtype=torch.int32, device=src.device)
            * tile)[None, :, None]
    d = s - base
    hop = torch.gather(s, -1, torch.clamp(d, 0, tile - 1).long())
    return torch.where((d >= 0) & (d < tile), hop, s).reshape(src.shape)


def local_round(src: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """One synchronous in-tile doubling round of (B, 65536) int32 maps with
    src[p] <= p, at `tile`, one of TILES (any other raises ValueError).
    Returns (B, 65536) int32. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    shift = check_tile("local_round", tile)
    if _build.on_cpu(src):
        return local_round_plain(src, tile)
    batch = src.shape[0]
    _build.require(src, torch.int32, (batch, N), "src")
    out = torch.empty_like(src)
    if batch:
        rc = _build.lib().snk_local_round(src.data_ptr(), out.data_ptr(),
                                          batch, shift, _build.stream())
        _build.check(rc, "local_round")
        local_round.launches += 1
    return out


local_round.launches = 0
