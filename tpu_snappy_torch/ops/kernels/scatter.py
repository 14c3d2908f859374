"""Additive scatters: the windowed one (the decode transport's, the
framed sidecar's and, at one limb, the encoder's placement) and the
full-height one of the encoder's overflow entries.

`scatter_windowed` ports tpu_snappy/ops/pallas/scatter.py:scatter_windowed
with its `limbs` (1-3) and `out_cells` (a multiple of 128 below 2^30) and
any `wrows` that fits the output: 192 at 3 limbs onto 65536 cells for the
decode transport, the buckets of sidecar.PARENT_WROWS for the framed
sidecar's pieces, and 32 at one limb onto 67584 cells for
place.place_block, which runs the same kernels (`check_windowed`,
`launch_windowed`). `scatter_block` ports scatter.py:scatter_block at
limbs 1-3 and any out_cells that is a multiple of 128. The CUDA kernels
are in csrc/scatter.cu: both give each block one tile of a row's output
in shared memory and write it once (`windowed_tile` and `block_tile` size
the tiles); scatter_windowed first summarises each 1024-source tile
(window base, kept range, drops) so that a block reads only the source
tiles that meet its cells (see the file's note). The plain versions
reproduce the window drop and the drop count exactly, so kernel and plain
agree bit for bit, counts included.
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
#: Limb counts the scatters take (the encoder's 1, scatter_block's default
#: 2, the decoder's 3).
MAX_LIMBS = 3
#: Largest out_cells: the kernels test destinations in unsigned 32 bits.
MAX_CELLS = 1 << 30


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


def _check_windowed(wrows: int, limbs: int, out_cells: int) -> None:
    """scatter_windowed's arguments (scatter.py:176-178): a window of at
    least one row that fits the output, 1-3 limbs, and out_cells a multiple
    of LO below MAX_CELLS (the kernel tests destinations in 32 bits)."""
    if (out_cells % LO or out_cells >= MAX_CELLS
            or not 1 <= wrows <= out_cells // LO):
        raise ValueError(f"scatter_windowed: wrows {wrows} (1 to "
                         f"out_cells / {LO}), out_cells {out_cells} (a "
                         f"multiple of {LO} below {MAX_CELLS})")
    if not 1 <= limbs <= MAX_LIMBS:
        raise ValueError(f"scatter_windowed: limbs {limbs} (1 to "
                         f"{MAX_LIMBS})")


def scatter_windowed_plain(dest: torch.Tensor, values: torch.Tensor,
                           wrows: int = WROWS, *, limbs: int = 3,
                           out_cells: int = N):
    """Plain PyTorch form: (out (B, out_cells) int32, ovf (B,) int32)."""
    _check_windowed(wrows, limbs, out_cells)
    batch, m = dest.shape
    tiles = dest.reshape(batch, m // TILE, TILE)
    active = (tiles >= 0) & (tiles < out_cells)
    mn = torch.where(active, tiles, _NONE).amin(dim=-1, keepdim=True)
    base = torch.clamp((mn >> 10) << 3, max=out_cells // LO - wrows)
    inside = (tiles >> 7) - base < wrows
    ovf = (active & ~inside).sum(dim=(1, 2), dtype=torch.int32)
    idx = torch.where(active & inside, tiles, out_cells).reshape(batch, m)
    idx = idx.to(torch.int64)
    acc = []
    for limb in _limbs(values, limbs):
        cell = torch.zeros((batch, out_cells + 1), dtype=torch.int32,
                           device=dest.device)
        acc.append(cell.scatter_add_(1, idx, limb)[:, :out_cells])
    return _join(acc), ovf


#: Cells of a scatter_windowed tile while the grid fills the card (48 KB
#: of planes at three limbs, four blocks an SM; at one limb 8192 cells fit
#: in less, but place_block's largest call ran slower at 8192 than at 4096
#: on an H100), and the least it is cut to.
WINDOWED_TILE = 4096
MIN_WINDOWED_TILE = 512
#: Blocks scatter_windowed aims for: four on each SM.
WINDOWED_BLOCKS = 4 * _build.SMS
#: Shared memory a scatter_windowed block keeps beside its planes (the
#: list of source tiles that meet it; kListBytes in csrc/scatter.cu).
_WINDOWED_LIST_BYTES = 4 * 1024 + 64


def windowed_tile(batch: int, out_cells: int = N) -> int:
    """Cells of one scatter_windowed output tile: WINDOWED_TILE, halved
    while the grid (batch x out_cells / tile blocks, the last of a row
    partial) stays below WINDOWED_BLOCKS, down to MIN_WINDOWED_TILE, and at
    most out_cells. At 126 or 128 rows that is 4096 (2016 or 2048 blocks at
    65536 cells, 2176 at place_block's 67584); at 2 rows 512. It fits
    shared memory at every limb count."""
    tile = WINDOWED_TILE
    while (tile > MIN_WINDOWED_TILE
           and batch * -(-out_cells // tile) < WINDOWED_BLOCKS):
        tile //= 2
    return min(tile, out_cells)


def scatter_windowed(dest: torch.Tensor, values: torch.Tensor,
                     wrows: int = WROWS, tile: int | None = None, *,
                     limbs: int = 3, out_cells: int = N):
    """Additive scatter of (B, M) int32 `values` to (B, M) int32 `dest`
    cells (M a multiple of 1024; a destination outside [0, out_cells)
    drops), each of `limbs` 8-bit limbs (the top one unmasked) summed per
    cell and the sums joined by shift-OR. Per 1024-source tile, writes
    `wrows` or more 128-cell rows past the tile's window base are dropped
    and counted. Returns (out (B, out_cells) int32, ovf (B,) int32). CPU
    tensors take the plain version; CUDA tensors launch the kernel, with
    `windowed_tile`'s output tile unless `tile` (cells, a multiple of 128)
    is given."""
    tile = check_windowed(dest.shape, wrows, tile, limbs, out_cells,
                          "scatter_windowed")
    if _build.on_cpu(dest, values):
        return scatter_windowed_plain(dest, values, wrows, limbs=limbs,
                                      out_cells=out_cells)
    out, ovf = launch_windowed(dest, values, wrows, tile, limbs, out_cells,
                               "scatter_windowed")
    if dest.numel():
        scatter_windowed.launches += 1
    return out, ovf


def check_windowed(shape, wrows: int, tile: int | None, limbs: int,
                   out_cells: int, name: str) -> int:
    """Raise on what the windowed kernels do not take (the CPU path
    refuses it too); returns the output tile, `windowed_tile`'s unless
    `tile` is given."""
    batch, m = shape
    _check_windowed(wrows, limbs, out_cells)
    if m % TILE:
        raise ValueError(f"{name}: width {m} is not a multiple of {TILE}")
    tile = windowed_tile(batch, out_cells) if tile is None else tile
    if (tile % LO or not 0 < tile <= out_cells
            or limbs * tile * 4 + _WINDOWED_LIST_BYTES > _build.SMEM_BYTES):
        raise ValueError(f"{name}: tile {tile} (a multiple of {LO} up to "
                         f"out_cells, {limbs} x 4 bytes a cell in shared "
                         f"memory)")
    return tile


def launch_windowed(dest: torch.Tensor, values: torch.Tensor, wrows: int,
                    tile: int, limbs: int, out_cells: int, name: str):
    """The windowed kernels on CUDA tensors, for arguments that passed
    check_windowed: (out, ovf), every entry written. The caller counts
    the launch (scatter_windowed and place_block, each its own)."""
    batch, m = dest.shape
    _build.require(dest, torch.int32, (batch, m), "dest")
    _build.require(values, torch.int32, (batch, m), "values")
    _build.require_aligned(name, dest, values)
    dev = dest.device
    out = torch.empty((batch, out_cells), dtype=torch.int32, device=dev)
    ovf = torch.empty((batch,), dtype=torch.int32, device=dev)
    if batch and m:
        summary = torch.empty((batch, m // TILE, 4), dtype=torch.int32,
                              device=dev)
        rc = _build.lib().snk_scatter_windowed(
            dest.data_ptr(), values.data_ptr(), summary.data_ptr(),
            out.data_ptr(), ovf.data_ptr(), m, out_cells, wrows, tile,
            limbs, batch, _build.stream())
        _build.check(rc, name)
    else:
        out.zero_()
        ovf.zero_()
    return out, ovf


scatter_windowed.launches = 0


#: Blocks scatter_block aims to launch: eight on each of the card's SMs.
FILL_BLOCKS = 8 * _build.SMS


def block_tile(out_cells: int, m: int, limbs: int, batch: int) -> int:
    """Cells of one scatter_block tile, a multiple of LO. A row is cut
    into tiles so that the grid reaches FILL_BLOCKS blocks, but no further
    than keeps the sources every tile re-reads (tiles x m x 8 bytes) at or
    below the row's output bytes (out_cells x 4): at M = 65536 sources
    onto 65536 cells that is one tile. The tile's accumulators (limbs x 4
    bytes a cell) must fit a block's shared memory, which can force more
    tiles than that."""
    units = out_cells // LO
    tiles = max(1, min(-(-FILL_BLOCKS // max(batch, 1)),
                       out_cells // (2 * max(m, 1)), units))
    per = min(-(-units // tiles), _build.SMEM_BYTES // (limbs * 4 * LO))
    return max(per, 1) * LO


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
                  out_cells: int = N, tile: int | None = None
                  ) -> torch.Tensor:
    """Full-height additive scatter of (B, M) int32 `values` to (B, M)
    int32 `dest` cells (M a multiple of 1024; a destination outside
    [0, out_cells) drops; duplicates sum per limb). Returns out
    (B, out_cells) int32, unwritten cells 0. CPU tensors take the plain
    version; CUDA tensors launch the kernel, with `block_tile`'s tile
    unless `tile` (cells, a multiple of 128) is given."""
    batch, m = dest.shape
    if (m % TILE or out_cells % LO or not 1 <= limbs <= MAX_LIMBS
            or out_cells >= MAX_CELLS):
        raise ValueError(f"scatter_block: width {m} (a multiple of {TILE}),"
                         f" out_cells {out_cells} (of {LO}, below "
                         f"{MAX_CELLS}), limbs {limbs} (1 to {MAX_LIMBS})")
    tile = block_tile(out_cells, m, limbs, batch) if tile is None else tile
    if tile % LO or not 0 < tile * limbs * 4 <= _build.SMEM_BYTES:
        raise ValueError(f"scatter_block: tile {tile} (a multiple of {LO}, "
                         f"{limbs} x 4 bytes a cell in at most "
                         f"{_build.SMEM_BYTES})")
    if _build.on_cpu(dest, values):
        return scatter_block_plain(dest, values, limbs, out_cells)
    _build.require(dest, torch.int32, (batch, m), "dest")
    _build.require(values, torch.int32, (batch, m), "values")
    out = torch.empty((batch, out_cells), dtype=torch.int32,
                      device=dest.device)
    _build.require_aligned("scatter_block", dest, values, out)
    if batch and m and out_cells:
        rc = _build.lib().snk_scatter_block(
            dest.data_ptr(), values.data_ptr(), out.data_ptr(), m, out_cells,
            limbs, tile, batch, _build.stream())
        _build.check(rc, "scatter_block")
        scatter_block.launches += 1
    else:
        out.zero_()
    return out


scatter_block.launches = 0
