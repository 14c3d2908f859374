"""Additive scatters: the decode transport's windowed one and the
full-height one of the encoder's overflow entries.

`scatter_windowed` ports tpu_snappy/ops/pallas/scatter.py:scatter_windowed
at limbs=3, out_cells=65536 and any `wrows` up to 512: 192 for the decode
transport, the buckets of sidecar.PARENT_WROWS for the framed sidecar's
pieces. `scatter_block` ports scatter.py:scatter_block at limbs 1-3 and
any out_cells that is a multiple of 128. The CUDA kernels are in
csrc/scatter.cu (integer atomics per limb, then a shift-OR join, see its
note). The plain versions reproduce the window drop and the drop count
exactly, so kernel and plain agree bit for bit, counts included.
"""

from __future__ import annotations

import torch

from . import _build

N = 1 << 16
SOURCE = "tpu_snappy_torch/ops/kernels/csrc/scatter.cu"
REPLACES = {"scatter_windowed": "tpu_snappy/ops/pallas/scatter.py:176",
            "scatter_block": "tpu_snappy/ops/pallas/scatter.py:74"}

#: Window rows of 128 cells per 1024-source tile, the decode transport's
#: (scatter.py:116).
WROWS = 192
#: Sources per window tile.
TILE = 1024
LO = 128

_NONE = 1 << 30  # min of a tile with no active destination


def _limbs(values: torch.Tensor, limbs: int = 3) -> list:
    """8-bit limbs, most significant first. The top limb is not masked
    (scatter.py:95): the transport's cells reach 2^24."""
    return [values >> (8 * (limbs - 1)) if j == 0
            else (values >> (8 * (limbs - 1 - j))) & 0xFF
            for j in range(limbs)]


def _join(acc: list) -> torch.Tensor:
    """Per-limb sums joined by shift-OR (scatter.py:61-64), not addition."""
    res = acc[0]
    for a in acc[1:]:
        res = (res << 8) | a
    return res


def _check_wrows(wrows: int) -> None:
    if not 1 <= wrows <= N // LO:
        raise ValueError(f"scatter_windowed: wrows {wrows} (1 to {N // LO})")


def scatter_windowed_plain(dest: torch.Tensor, values: torch.Tensor,
                           wrows: int = WROWS):
    """Plain PyTorch form: (out (B, 65536) int32, ovf (B,) int32)."""
    _check_wrows(wrows)
    batch, m = dest.shape
    tiles = dest.reshape(batch, m // TILE, TILE)
    active = (tiles >= 0) & (tiles < N)
    mn = torch.where(active, tiles, _NONE).amin(dim=-1, keepdim=True)
    base = torch.clamp((mn >> 10) << 3, max=N // LO - wrows)
    inside = (tiles >> 7) - base < wrows
    ovf = (active & ~inside).sum(dim=(1, 2), dtype=torch.int32)
    idx = torch.where(active & inside, tiles, N).reshape(batch, m)
    idx = idx.to(torch.int64)
    acc = []
    for limb in _limbs(values):
        cell = torch.zeros((batch, N + 1), dtype=torch.int32,
                           device=dest.device)
        acc.append(cell.scatter_add_(1, idx, limb)[:, :N])
    return _join(acc), ovf


def scatter_windowed(dest: torch.Tensor, values: torch.Tensor,
                     wrows: int = WROWS):
    """Additive scatter of (B, M) int32 `values` to (B, M) int32 `dest`
    cells (M a multiple of 1024; a destination outside [0, 65536) drops).
    Per 1024-source tile, writes `wrows` or more 128-cell rows past the
    tile's window base are dropped and counted. Returns (out (B, 65536)
    int32, ovf (B,) int32). CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    batch, m = dest.shape
    _check_wrows(wrows)
    if m % TILE:
        raise ValueError(f"scatter_windowed: width {m} is not a multiple "
                         f"of {TILE}")
    if _build.on_cpu(dest, values):
        return scatter_windowed_plain(dest, values, wrows)
    _build.require(dest, torch.int32, (batch, m), "dest")
    _build.require(values, torch.int32, (batch, m), "values")
    dev = dest.device
    acc = torch.zeros((batch, 3, N), dtype=torch.int32, device=dev)
    out = torch.empty((batch, N), dtype=torch.int32, device=dev)
    ovf = torch.zeros((batch,), dtype=torch.int32, device=dev)
    if batch and m:
        rc = _build.lib().snk_scatter_windowed(
            dest.data_ptr(), values.data_ptr(), acc.data_ptr(),
            out.data_ptr(), ovf.data_ptr(), m, N, wrows, batch,
            _build.stream())
        _build.check(rc, "scatter_windowed")
        scatter_windowed.launches += 1
    else:
        out.zero_()
    return out, ovf


scatter_windowed.launches = 0


#: Limb counts scatter_block takes (the encoder's 1, the default 2, the
#: decoder's 3).
MAX_LIMBS = 3


def scatter_block_plain(dest: torch.Tensor, values: torch.Tensor,
                        limbs: int = 2, out_cells: int = N) -> torch.Tensor:
    """Plain PyTorch form: out (B, out_cells) int32."""
    batch = dest.shape[0]
    keep = (dest >= 0) & (dest < out_cells)
    idx = torch.where(keep, dest, out_cells).to(torch.int64)
    acc = []
    for limb in _limbs(values, limbs):
        cell = torch.zeros((batch, out_cells + 1), dtype=torch.int32,
                           device=dest.device)
        acc.append(cell.scatter_add_(1, idx, limb)[:, :out_cells])
    return _join(acc)


def scatter_block(dest: torch.Tensor, values: torch.Tensor, limbs: int = 2,
                  out_cells: int = N) -> torch.Tensor:
    """Full-height additive scatter of (B, M) int32 `values` to (B, M)
    int32 `dest` cells (M a multiple of 1024; a destination outside
    [0, out_cells) drops; duplicates sum per limb). Returns out
    (B, out_cells) int32, unwritten cells 0. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    batch, m = dest.shape
    if m % TILE or out_cells % LO or not 1 <= limbs <= MAX_LIMBS:
        raise ValueError(f"scatter_block: width {m} (a multiple of {TILE}),"
                         f" out_cells {out_cells} (of {LO}), limbs {limbs} "
                         f"(1 to {MAX_LIMBS})")
    if _build.on_cpu(dest, values):
        return scatter_block_plain(dest, values, limbs, out_cells)
    _build.require(dest, torch.int32, (batch, m), "dest")
    _build.require(values, torch.int32, (batch, m), "values")
    dev = dest.device
    out = torch.zeros((batch, out_cells), dtype=torch.int32, device=dev)
    # One limb adds straight into the output; more need per-limb sums.
    acc = (out if limbs == 1 else
           torch.zeros((batch, limbs, out_cells), dtype=torch.int32,
                       device=dev))
    if batch and m:
        rc = _build.lib().snk_scatter_block(
            dest.data_ptr(), values.data_ptr(), acc.data_ptr(),
            out.data_ptr(), m, out_cells, limbs, batch, _build.stream())
        _build.check(rc, "scatter_block")
        scatter_block.launches += 1
    return out


scatter_block.launches = 0
