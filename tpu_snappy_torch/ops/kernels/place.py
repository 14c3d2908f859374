"""Monotone-destination byte placement of the encoder's main lane.

Port of tpu_snappy/ops/pallas/place.py:place_block. What it computes,
exactly as the TPU kernel does: `out[dest] = value` summed over
duplicates, where per 1024-source tile the window base row is
`min((m >> 10) << 3, out_rows - 32)` for the tile's smallest active
destination m, and a write whose 128-cell row falls outside
`[base, base + 32)` is dropped and counted in `ovf`. Inactive means
`dest >= out_rows * 128`; a negative destination, outside the TPU
kernel's contract, is inactive here.

That is scatter.py's windowed scatter at one limb (the value unmasked,
summed per cell), wrows W and out_cells out_rows * 128, word for word: on
the card place_block launches the windowed scatter's kernels
(csrc/scatter.cu, see its note) at those arguments. They write every
output cell and drop count once, so nothing is zeroed beforehand.
`place_block_plain` stays the placement's own statement of the rule.
"""

from __future__ import annotations

import torch

from . import _build
from . import scatter as _scatter

SOURCE = "tpu_snappy_torch/ops/kernels/csrc/scatter.cu"
REPLACES = "tpu_snappy/ops/pallas/place.py:94"

#: Window rows of 128 cells per source tile (place.py:36).
W = 32
#: Sources per window tile (place.py:37, TR * TC).
TILE = 1024
LO = 128
#: Limbs of the windowed scatter that place_block runs: one, since the
#: values are bytes.
LIMBS = 1

_NONE = 1 << 30  # min of a tile with no active destination


def place_block_plain(dest: torch.Tensor, values: torch.Tensor,
                      out_rows: int):
    """Plain PyTorch form: (out (B, out_rows*128) int32, ovf (B,) int32)."""
    batch, m = dest.shape
    cap = out_rows * LO
    tiles = dest.reshape(batch, m // TILE, TILE)
    active = (tiles >= 0) & (tiles < cap)
    mn = torch.where(active, tiles, _NONE).amin(dim=-1, keepdim=True)
    base = torch.clamp((mn >> 10) << 3, max=out_rows - W)
    inside = (tiles >> 7) - base < W
    ovf = (active & ~inside).sum(dim=(1, 2), dtype=torch.int32)
    idx = torch.where(active & inside, tiles, cap).reshape(batch, m)
    out = torch.zeros((batch, cap + 1), dtype=torch.int32, device=dest.device)
    out.scatter_add_(1, idx.to(torch.int64), values)
    return out[:, :cap], ovf


def place_block(dest: torch.Tensor, values: torch.Tensor, out_rows: int):
    """Place (B, M) int32 `values` at (B, M) int32 `dest` cells of a
    (B, out_rows*128) output (M a multiple of 1024, out_rows >= 32).
    Returns (out (B, out_rows*128) int32, unwritten cells 0; ovf (B,)
    int32 window-contract violations, dropped). CPU tensors take the plain
    version; CUDA tensors launch the windowed scatter's kernels at one
    limb."""
    batch, m = dest.shape
    if m % TILE or out_rows < W:
        raise ValueError(f"place_block: width {m} must be a multiple of "
                         f"{TILE} and out_rows {out_rows} at least {W}")
    cells = out_rows * LO
    tile = _scatter.check_windowed(dest.shape, W, None, LIMBS, cells,
                                   "place_block")
    if _build.on_cpu(dest, values):
        return place_block_plain(dest, values, out_rows)
    out, ovf = _scatter.launch_windowed(dest, values, W, tile, LIMBS, cells,
                                        "place_block")
    if dest.numel():
        place_block.launches += 1
    return out, ovf


place_block.launches = 0
