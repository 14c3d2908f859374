"""Windowed additive scatter of the decode transport (three 8-bit limbs).

Port of tpu_snappy/ops/pallas/scatter.py:scatter_windowed at limbs=3,
out_cells=65536, wrows=192: the decode transport (the sidecar's smaller
`wrows` waits for the framed slice).
The CUDA kernel is csrc/scatter.cu (integer atomics per limb inside each
1024-source tile's window, then a shift-OR join, see its note). The plain
version below reproduces the window drop and the drop count exactly, so
kernel and plain agree bit for bit, counts included.
"""

from __future__ import annotations

import torch

from . import _build

N = 1 << 16
SOURCE = "tpu_snappy_torch/ops/kernels/csrc/scatter.cu"
REPLACES = "tpu_snappy/ops/pallas/scatter.py:176"

#: Window rows of 128 cells per 1024-source tile (scatter.py:116).
WROWS = 192
#: Sources per window tile.
TILE = 1024
LO = 128

_NONE = 1 << 30  # min of a tile with no active destination


def _limbs(values: torch.Tensor) -> tuple:
    # The top limb is not masked: the transport's cells reach 2^24.
    return values >> 16, (values >> 8) & 0xFF, values & 0xFF


def scatter_windowed_plain(dest: torch.Tensor, values: torch.Tensor):
    """Plain PyTorch form: (out (B, 65536) int32, ovf (B,) int32)."""
    batch, m = dest.shape
    tiles = dest.reshape(batch, m // TILE, TILE)
    active = (tiles >= 0) & (tiles < N)
    mn = torch.where(active, tiles, _NONE).amin(dim=-1, keepdim=True)
    base = torch.clamp((mn >> 10) << 3, max=N // LO - WROWS)
    inside = (tiles >> 7) - base < WROWS
    ovf = (active & ~inside).sum(dim=(1, 2), dtype=torch.int32)
    idx = torch.where(active & inside, tiles, N).reshape(batch, m)
    idx = idx.to(torch.int64)
    acc = []
    for limb in _limbs(values):
        cell = torch.zeros((batch, N + 1), dtype=torch.int32,
                           device=dest.device)
        acc.append(cell.scatter_add_(1, idx, limb)[:, :N])
    return (acc[0] << 16) | (acc[1] << 8) | acc[2], ovf


def scatter_windowed(dest: torch.Tensor, values: torch.Tensor):
    """Additive scatter of (B, M) int32 `values` to (B, M) int32 `dest`
    cells (M a multiple of 1024; a destination outside [0, 65536) drops).
    Per 1024-source tile, writes more than WROWS 128-cell rows past the
    tile's window base are dropped and counted. Returns (out (B, 65536)
    int32, ovf (B,) int32). CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    batch, m = dest.shape
    if m % TILE:
        raise ValueError(f"scatter_windowed: width {m} is not a multiple "
                         f"of {TILE}")
    if _build.on_cpu(dest, values):
        return scatter_windowed_plain(dest, values)
    _build.require(dest, torch.int32, (batch, m), "dest")
    _build.require(values, torch.int32, (batch, m), "values")
    dev = dest.device
    acc = torch.zeros((batch, 3, N), dtype=torch.int32, device=dev)
    out = torch.empty((batch, N), dtype=torch.int32, device=dev)
    ovf = torch.zeros((batch,), dtype=torch.int32, device=dev)
    if batch and m:
        rc = _build.lib().snk_scatter_windowed(
            dest.data_ptr(), values.data_ptr(), acc.data_ptr(),
            out.data_ptr(), ovf.data_ptr(), m, N, WROWS, batch,
            _build.stream())
        _build.check(rc, "scatter_windowed")
        scatter_windowed.launches += 1
    else:
        out.zero_()
    return out, ovf


scatter_windowed.launches = 0
