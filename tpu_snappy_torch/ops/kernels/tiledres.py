"""Copy-chain resolution: out[p] = lit[fix(src)[p]].

Ports tpu_snappy/ops/pallas/tiledres.py:resolve_tiled (with its
`resolved` flag, every tile, `check` and every `variant`: "pair", "tri"
and "grid" give "fori"'s bytes), tiledres.py:resolve_tiled_dual (two
fragments in one call, which the batched kernel is already),
tiledres.py:resolve_tiled_depth and tiledres.py:resolve_tiled_flag, each
at every tile the TPU kernels take (localround.TILES: 128 << k positions,
k = 0..9). The CUDA kernels are csrc/tiledres.cu; see its note. `src[p]
<= p` must hold, as decode guarantees: it is what makes the fixed point
exist and the tile walk exact. `lit` holds bytes (0-255), as decode's
literal plane does.

What the TPU computes is a walk over the tiles, left to right: in-tile
pointer doubling, then an absorb that reads lit at or right of the tile
base and the row's own final output left of it. The kernels give the
walk's bytes without walking: one block a row keeps the row's map in
shared memory, runs every tile's doubling rounds at once (exactly the
declared count for resolve_tiled_depth; until nothing moves, in
1024-tiles, for a resolve_tiled row that is not flagged `resolved`,
whose walk bytes are lit[fix(src)] at every tile, and for a
resolve_tiled_flag row with no over-approximate flag, whose tiles all
reach their local fixed points; for any other resolve_tiled_flag row
while the tile's vote before the round finds a lane in-tile with flag 0
and the round moves a pointer), and replaces the chain of absorbs by
log2(tiles) levels that merge pairs of tile blocks, each lane taking at
most one pointer a level. The absorb's recursion out[p] = out[v] (v left
of p's tile) is exactly what the merges follow to a terminal lane.

The variants: "pair" absorbs two tiles from the byte plane as it stood
before either, then gives the right tile's lanes that point into the left
tile that tile's fresh bytes, which are what "fori" reads there; "tri"
reads only the plane's rows left of the tile's end, where every source
lies; "grid" runs the tiles as grid steps. Each gives "fori"'s bytes, on
`resolved` rows off their fixed point too, and `check` (rounds between
convergence tests) only adds rounds after a tile's local fixed point,
which change nothing. "pair" needs an even count of tiles, so it refuses
the 65536-tile, as the TPU kernel does.

The plain versions simulate the same tile walk, round for round, so they
agree with the kernels (and the TPU) also where the walk does not reach
the fixed point: a `resolved` flag given for a map that is not at its
fixed point, an under-declared depth, or an over-approximate root flag.
"""

from __future__ import annotations

import torch

from . import _build
from . import localround as _localround
from .localround import check_tile

N = 1 << 16
SOURCE = "tpu_snappy_torch/ops/kernels/csrc/tiledres.cu"
REPLACES = {"resolve_tiled": "tpu_snappy/ops/pallas/tiledres.py:764",
            "resolve_tiled_dual": "tpu_snappy/ops/pallas/tiledres.py:678",
            "resolve_tiled_depth": "tpu_snappy/ops/pallas/tiledres.py:736",
            "resolve_tiled_flag": "tpu_snappy/ops/pallas/tiledres.py:709"}

#: Positions per sequential tile by default (tiledres.py:50, the decoder's
#: TAIL_TILE).
TILE = 4096
#: Positions per tile of the decoder's depth-hinted resolve (its
#: HINT_TILE), and the framed 0x81 hints' tile.
DEPTH_TILE = 1024
#: Every tile the kernels take (128 << k, k = 0..9), local_round's too.
TILES = _localround.TILES
#: resolve_tiled's variants (tiledres.py:791-812), all the same bytes.
VARIANTS = ("fori", "pair", "tri", "grid")


def _check_resolve(name: str, tile: int, check: int = 1,
                   variant: str = "fori") -> int:
    """Raise ValueError for a tile outside TILES, a `check` below 1 or an
    unknown variant ("pair" also at the 65536-tile: it absorbs tiles in
    pairs). Returns the tile's log2."""
    shift = check_tile(name, tile)
    if not isinstance(check, int) or check < 1:
        raise ValueError(f"{name}: check {check!r}; a count of rounds, "
                         "at least 1")
    if variant not in VARIANTS:
        raise ValueError(f"{name}: variant {variant!r}; one of {VARIANTS}")
    if variant == "pair" and (N // tile) % 2:
        raise ValueError(f"{name}: variant 'pair' needs an even count of "
                         f"tiles; tile {tile} gives {N // tile}")
    return shift


def _tile_walk(lit: torch.Tensor, src: torch.Tensor, tile: int,
               budget, flags: torch.Tensor | None = None) -> torch.Tensor:
    """The TPU kernels' walk: per tile, left to right, in-tile doubling
    rounds (at most budget(t) per row, (B,) int64; a round that moves
    nothing ends the row's loop, as it changes nothing), then one absorb
    from the byte plane (lit right of the tile base, final bytes left of
    it). With `flags` ((B, 65536) root flags) it is resolve_tiled_flag's
    walk instead: before every round a row tests, on its current state,
    whether some lane points in-tile with flag 0, and stops if none does;
    a round moves each in-tile lane's flag with its pointer; no `moved`
    break."""
    plane = lit.clone()
    for t in range(N // tile):
        base = t * tile
        s = src[:, base:base + tile]
        f = None if flags is None else flags[:, base:base + tile] != 0
        rounds = budget(t)
        active = rounds > 0
        r = 0
        while True:
            if f is not None:
                active &= ((s >= base) & ~f).any(dim=-1)
            if not bool(active.any()):
                break
            d = s - base
            inside = (d >= 0) & (d < tile)
            dc = torch.clamp(d, 0, tile - 1).long()
            s2 = torch.where(inside, torch.gather(s, -1, dc), s)
            if f is not None:
                f = torch.where(active[:, None] & inside,
                                torch.gather(f, -1, dc), f)
            moved = (s2 != s).any(dim=-1)
            s = torch.where(active[:, None], s2, s)
            r += 1
            active &= rounds > r
            if f is None:
                active &= moved
        plane[:, base:base + tile] = torch.gather(plane, -1, s.long())
    return plane


def resolve_tiled_plain(lit: torch.Tensor, src: torch.Tensor,
                        resolved: torch.Tensor | None = None,
                        tile: int = TILE, check: int = 1,
                        variant: str = "fori") -> torch.Tensor:
    """Plain PyTorch form of resolve_tiled: the tile walk at `tile` with up
    to bit_length(tile) rounds a tile, rounded up to whole groups of
    `check`, none in rows flagged `resolved`; every variant walks so."""
    _check_resolve("resolve_tiled", tile, check, variant)
    most = -(-tile.bit_length() // check) * check
    rounds = torch.full((lit.shape[0],), most, dtype=torch.int64,
                        device=lit.device)
    if resolved is not None:
        rounds = torch.where(resolved, 0, rounds)
    return _tile_walk(lit, src, tile, lambda t: rounds)


def _launch_tiled(name: str, lit: torch.Tensor, src: torch.Tensor,
                  resolved: torch.Tensor | None, shift: int) -> torch.Tensor:
    """Checks, then one launch of the resolve_tiled kernel at tile
    2^shift. Returns (B, 65536) int32."""
    batch = lit.shape[0]
    _build.require(lit, torch.int32, (batch, N), "lit")
    _build.require(src, torch.int32, (batch, N), "src")
    if resolved is not None:
        _build.require(resolved, torch.bool, (batch,), "resolved")
    _build.require_aligned(name, src)
    out = torch.empty_like(lit)
    if batch:
        rc = _build.lib().snk_resolve_tiled(
            lit.data_ptr(), src.data_ptr(),
            None if resolved is None else resolved.data_ptr(),
            out.data_ptr(), batch, shift, _build.stream())
        _build.check(rc, name)
    return out


def resolve_tiled(lit: torch.Tensor, src: torch.Tensor,
                  resolved: torch.Tensor | None = None, tile: int = TILE,
                  check: int = 1, variant: str = "fori") -> torch.Tensor:
    """Resolve (B, 65536) int32 `src` maps against (B, 65536) int32 `lit`
    bytes. `resolved` (B,) bool, optional: rows the caller has proven to be
    at their fixed point, which skip every doubling round and run only the
    absorbs (at `tile`, which then decides the bytes of a row that is not
    at its fixed point). tile: one of TILES; check: rounds between
    convergence tests, at least 1; variant: one of VARIANTS (every one
    gives the same bytes; "pair" refuses the 65536-tile). Anything else
    raises ValueError. Returns (B, 65536) int32. CPU tensors take the
    plain version; CUDA tensors launch the kernel (`src` must start
    16-byte aligned, as a fresh allocation does)."""
    shift = _check_resolve("resolve_tiled", tile, check, variant)
    args = (lit, src) if resolved is None else (lit, src, resolved)
    if _build.on_cpu(*args):
        return resolve_tiled_plain(lit, src, resolved, tile, check, variant)
    out = _launch_tiled("resolve_tiled", lit, src, resolved, shift)
    if lit.shape[0]:
        resolve_tiled.launches += 1
    return out


resolve_tiled.launches = 0


def _check_dual(lit2: torch.Tensor, tile: int, check: int) -> int:
    shift = _check_resolve("resolve_tiled_dual", tile, check)
    if lit2.shape[0] != 2:
        raise ValueError(f"resolve_tiled_dual: {lit2.shape[0]} fragments; "
                         "it takes two")
    return shift


def resolve_tiled_dual_plain(lit2: torch.Tensor, src2: torch.Tensor,
                             resolved2: torch.Tensor | None = None,
                             tile: int = TILE, check: int = 1) -> torch.Tensor:
    """Plain PyTorch form of resolve_tiled_dual: resolve_tiled_plain on the
    two rows."""
    _check_dual(lit2, tile, check)
    return resolve_tiled_plain(lit2, src2, resolved2, tile, check)


def resolve_tiled_dual(lit2: torch.Tensor, src2: torch.Tensor,
                       resolved2: torch.Tensor | None = None,
                       tile: int = TILE, check: int = 1) -> torch.Tensor:
    """resolve_tiled on two fragments in one launch: lit2, src2 (2, 65536)
    int32, resolved2 optional (2,) bool; each row of the result equals
    resolve_tiled on that fragment at the same tile and check. The TPU's
    variant shares one kernel's fixed cost between two fragments; the CUDA
    kernel is batched over rows, so this launches it at B = 2. Returns
    (2, 65536) int32. CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    shift = _check_dual(lit2, tile, check)
    args = (lit2, src2) if resolved2 is None else (lit2, src2, resolved2)
    if _build.on_cpu(*args):
        return resolve_tiled_plain(lit2, src2, resolved2, tile, check)
    out = _launch_tiled("resolve_tiled_dual", lit2, src2, resolved2, shift)
    resolve_tiled_dual.launches += 1
    return out


resolve_tiled_dual.launches = 0


def resolve_tiled_depth_plain(lit: torch.Tensor, src: torch.Tensor,
                              depths: torch.Tensor,
                              tile: int = TILE) -> torch.Tensor:
    """Plain PyTorch form of resolve_tiled_depth: the tile walk with
    exactly min(max(depths[:, t], 0), bit_length(tile)) rounds in tile
    t."""
    check_tile("resolve_tiled_depth", tile)
    rounds = torch.clamp(depths.to(torch.int64), 0, tile.bit_length())
    return _tile_walk(lit, src, tile, lambda t: rounds[:, t])


def tile_depths_plain(src: torch.Tensor,
                      tile: int = DEPTH_TILE) -> torch.Tensor:
    """Each tile's local doubling depth in (B, 65536) int32 maps: the
    in-tile rounds that move something, the depth a framed 0x81 hint
    declares for a tile (at DEPTH_TILE). Returns (B, 65536 // tile)
    int32."""
    check_tile("tile_depths_plain", tile)
    depths = torch.zeros((src.shape[0], N // tile), dtype=torch.int32,
                         device=src.device)
    for t in range(N // tile):
        base = t * tile
        s = src[:, base:base + tile]
        while True:
            d = s - base
            hop = torch.gather(s, -1, torch.clamp(d, 0, tile - 1).long())
            s2 = torch.where((d >= 0) & (d < tile), hop, s)
            moved = (s2 != s).any(dim=-1)
            if not bool(moved.any()):
                break
            depths[:, t] += moved.to(torch.int32)
            s = s2
    return depths


def resolve_tiled_depth(lit: torch.Tensor, src: torch.Tensor,
                        depths: torch.Tensor,
                        tile: int = TILE) -> torch.Tensor:
    """Resolve with per-tile round counts: (B, 65536 // tile) int32
    `depths`, one per tile (16 at the default 4096, 64 at the decoder's
    DEPTH_TILE), each meant to be at least the tile's local depth (an
    under-declared one gives wrong bytes, as on the TPU). tile: one of
    TILES (others raise ValueError; the Pallas kernel keeps its depths in
    one 128-lane row, so it runs from the 512-tile up, and the port also
    takes 128 and 256, where the C++ golden's hints are defined too).
    lit, src: (B, 65536) int32, lit bytes. Returns (B, 65536) int32. CPU tensors take the plain version;
    CUDA tensors launch the kernel (`src` must start 16-byte aligned)."""
    shift = check_tile("resolve_tiled_depth", tile)
    if _build.on_cpu(lit, src, depths):
        return resolve_tiled_depth_plain(lit, src, depths, tile)
    batch = lit.shape[0]
    _build.require(lit, torch.int32, (batch, N), "lit")
    _build.require(src, torch.int32, (batch, N), "src")
    _build.require(depths, torch.int32, (batch, N // tile), "depths")
    _build.require_aligned("resolve_tiled_depth", src)
    out = torch.empty_like(lit)
    if batch:
        rc = _build.lib().snk_resolve_tiled_depth(
            lit.data_ptr(), src.data_ptr(), depths.data_ptr(),
            out.data_ptr(), batch, shift, _build.stream())
        _build.check(rc, "resolve_tiled_depth")
        resolve_tiled_depth.launches += 1
    return out


resolve_tiled_depth.launches = 0


def resolve_tiled_flag_plain(lit: torch.Tensor, src: torch.Tensor,
                             flags: torch.Tensor,
                             tile: int = TILE) -> torch.Tensor:
    """Plain PyTorch form of resolve_tiled_flag: the flag walk, at most
    bit_length(tile) rounds a tile."""
    check_tile("resolve_tiled_flag", tile)
    rounds = torch.full((lit.shape[0],), tile.bit_length(),
                        dtype=torch.int64, device=lit.device)
    return _tile_walk(lit, src, tile, lambda t: rounds, flags)


def resolve_tiled_flag(lit: torch.Tensor, src: torch.Tensor,
                       flags: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """Resolve with exact per-lane root flags: (B, 65536) int32 `flags`,
    flags[p] != 0 iff src[p] is a fixed point of src (the decoder's
    "flagtail" computes them as litv[src]). Each tile (one of TILES; others
    raise ValueError) runs rounds while a lane points in-tile at a
    non-root, on its current state. An over-approximate flag (set on an
    unresolved lane) gives wrong bytes, as on the TPU, which depend on the
    tile; all-zero flags run every round and stay exact. lit, src:
    (B, 65536) int32, src[p] <= p. Returns (B, 65536) int32. CPU tensors
    take the plain version; CUDA tensors launch the kernel (`src` and
    `flags` must start 16-byte aligned)."""
    shift = check_tile("resolve_tiled_flag", tile)
    if _build.on_cpu(lit, src, flags):
        return resolve_tiled_flag_plain(lit, src, flags, tile)
    batch = lit.shape[0]
    _build.require(lit, torch.int32, (batch, N), "lit")
    _build.require(src, torch.int32, (batch, N), "src")
    _build.require(flags, torch.int32, (batch, N), "flags")
    _build.require_aligned("resolve_tiled_flag", src, flags)
    out = torch.empty_like(lit)
    if batch:
        rc = _build.lib().snk_resolve_tiled_flag(
            lit.data_ptr(), src.data_ptr(), flags.data_ptr(), out.data_ptr(),
            batch, shift, _build.stream())
        _build.check(rc, "resolve_tiled_flag")
        resolve_tiled_flag.launches += 1
    return out


resolve_tiled_flag.launches = 0
