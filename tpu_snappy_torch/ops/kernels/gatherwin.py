"""Anchored-window doubling step: per 4096-target tile, a window of 8192
table positions under the tile's largest index; y[p] = x[idx[p]] inside
it, else idx[p], and inwin[p] says which.

Port of tpu_snappy/ops/pallas/gatherwin.py:gather_window_anchored, the two
opening rounds of the decoder's resolve="hybrid" when WINDOWED_OPENING is
set. The window of tile t starts at anchor * 4096 with anchor =
min(max(idx over t) >> 12, 14), so it always holds the tile's largest
index. The CUDA kernel is csrc/gatherwin.cu: one block per (row, tile)
finds the anchor, stages the window in shared memory and gathers from it.
Values are 16 bits, as the TPU's two int8 limbs keep; the plain version
raises on a table value outside [0, 65536). Indices lie in [0, 65536).
"""

from __future__ import annotations

import torch

from . import _build

N = 1 << 16
SOURCE = "tpu_snappy_torch/ops/kernels/csrc/gatherwin.cu"
REPLACES = "tpu_snappy/ops/pallas/gatherwin.py:83"

#: Targets per tile, window length, and the last anchor (gatherwin.py:35-41).
TILE = 4096
WINDOW = 8192
MAX_ANCHOR = N // TILE - 2


def gather_window_anchored_plain(x: torch.Tensor, idx: torch.Tensor):
    """Plain PyTorch form: (y, inwin), each (B, 65536) int32. Raises
    ValueError when a value of x does not fit 16 bits."""
    if x.numel() and (int(x.min()) < 0 or int(x.max()) >= 1 << 16):
        raise ValueError("gather_window_anchored: table values exceed 16 "
                         "bits")
    b = idx.shape[0]
    tiles = idx.reshape(b, N // TILE, TILE)
    anchor = torch.clamp(tiles.amax(dim=-1) >> 12, 0, MAX_ANCHOR)
    d = tiles - (anchor * TILE)[:, :, None]
    inwin = ((d >= 0) & (d < WINDOW)).reshape(b, N)
    got = torch.gather(x, -1, torch.clamp(idx, 0, N - 1).long())
    y = torch.where(inwin, got, idx).to(torch.int32)
    return y, inwin.to(torch.int32)


def gather_window_anchored(x: torch.Tensor, idx: torch.Tensor):
    """One anchored-window doubling step of (B, 65536) int32 `idx` over the
    table `x` (the decoder passes its map as both). Returns (y, inwin),
    each (B, 65536) int32. CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if _build.on_cpu(x, idx):
        return gather_window_anchored_plain(x, idx)
    batch = x.shape[0]
    _build.require(x, torch.int32, (batch, N), "x")
    _build.require(idx, torch.int32, (batch, N), "idx")
    y = torch.empty_like(idx)
    inwin = torch.empty_like(idx)
    if batch:
        rc = _build.lib().snk_gather_window_anchored(
            x.data_ptr(), idx.data_ptr(), y.data_ptr(), inwin.data_ptr(),
            batch, _build.stream())
        _build.check(rc, "gather_window_anchored")
        gather_window_anchored.launches += 1
    return y, inwin


gather_window_anchored.launches = 0
