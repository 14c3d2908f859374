"""Seeded inputs shared by chip_smoke.py and the port's tests.

`make_data` is the mixed round-trip input; `block_mix` a smaller mix whose
64 KB blocks take every framed path (hinted text, a root-mapped run,
stored random bytes); `CORRUPT_STREAM` a raw stream that no decoder can
decode, though its fragments split cleanly; `synthetic_parse` a committed
parse with long literal runs and far copies; `matcher_edge_rows` and
`emit_edge_parses` the rows that land on the tiles of the matcher and
emission kernels (ops/kernels/matcher.py:TILE, emit.py:TILE), read from
the kernel modules so that a change of tiling moves the rows with it.
chip_smoke.py holds the CUDA kernels against their plain versions on
them; tests/test_torch_matcher.py and tests/test_torch_emit.py hold the
kernels' tile restatements against the plain versions and the Pallas
kernels on the CPU. `tiled_resolve_rows`, `resolved_flags` and
`depth_variant` are the maps, flags and depths of the tiled resolves
(ops/kernels/tiledres.py), for tests/test_torch_tiledres.py and
chip_smoke.py's phase 3, whose maps also feed resolve_block
(tests/test_torch_doubling.py); `next_start_edge_rows` the single flags
at next_start_block's span and read-ahead edges (ops/kernels/scans.py),
for tests/test_torch_scans.py and phase 3; `place_edge_rows` the
adversarial destinations
of place_block and `limb_rows` those of the windowed scatter at 1-3 limbs
and other out_cells, for tests/test_torch_place.py, test_torch_kernels.py
and phase 3. `matcher_ops` restates the wide matcher kernel's sticky
stage in torch (held to the plain composition by
tests/test_torch_wide_k.py) and counts the integer operations a matcher
call needs on its own table, at every K: chip_smoke.py's phase 9 bounds
both matcher forms by it. `wide_sticky`, `wide_mask` and `wide_lane_map`
restate the wide kernel's walk, its prefilter and its unpacked mask
pass's reads, for tests/test_torch_wide_matcher.py. numpy only elsewhere, besides the kernel
modules and the port's corpus synthesis.
"""

import functools

import numpy as np
import torch

from tpu_snappy_torch.ops import encode
from tpu_snappy_torch.ops.kernels import emit, matcher, scans, tiledres
from tpu_snappy_torch.utils import corpus

SEED = 20261016
N = 1 << 16

#: 64 KB of RLE 'x' (a literal, then 1024 copies), then a copy whose
#: offset (65537) exceeds everything written (tests/test_serving.py): two
#: fragments, the second flagged on the device and refused by the host.
CORRUPT_STREAM = (b"\x84\x80\x04" + b"\x3c" + b"x" * 16
                  + (b"\xfe\x10\x00" * 1023) + b"\xbe\x10\x00"
                  + b"\x0f" + (65537).to_bytes(4, "little"))


def make_data(size: int, seed: int = SEED) -> bytes:
    """Seeded mix: Zipf-drawn words with numbers, random printable ASCII,
    incompressible bytes (literal runs over 60 and over 256 bytes), runs
    of one byte, and a partial last block."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    vocab = [bytes(letters[rng.integers(0, 26, rng.integers(2, 11))])
             for _ in range(5000)]
    target = size - 12345  # the last block stays partial
    pieces, total = [], 0
    while total < target:
        kind = rng.choice(4, p=[0.55, 0.15, 0.15, 0.15])
        if kind == 0:
            words = [vocab[i % len(vocab)]
                     for i in rng.zipf(1.3, rng.integers(200, 3000))]
            for j in np.flatnonzero(rng.random(len(words)) < 0.08):
                words[j] = str(int(rng.integers(0, 1_000_000))).encode()
            piece = b" ".join(words) + b".\n"
        elif kind == 1:
            piece = rng.integers(32, 127, rng.integers(100, 20000),
                                 dtype=np.uint8).tobytes()
        elif kind == 2:
            piece = rng.integers(0, 256, rng.integers(61, 5000),
                                 dtype=np.uint8).tobytes()
        else:
            piece = bytes([int(rng.integers(0, 256))]) * int(
                rng.integers(10, 30000))
        pieces.append(piece)
        total += len(piece)
    return b"".join(pieces)[:target]


def _words(rng, n: int) -> bytes:
    vocab = [bytes(rng.integers(97, 123, rng.integers(2, 11)).astype(np.uint8))
             for _ in range(3000)]
    return b" ".join(vocab[i % len(vocab)]
                     for i in rng.zipf(1.3, n // 3))[:n]


def block_mix(n: int, seed: int = 23) -> bytes:
    """n bytes, block by block: three blocks of Zipf word text (0x81 depth
    hints under framed "auto"), a one-byte run (a 0x80 root map), two of
    corpus.synth random ASCII and one of random bytes (both stored
    uncompressed when framed), then word text again."""
    rng = np.random.default_rng(seed)
    data = (_words(rng, 3 * N) + b"z" * N + corpus.synth("random", 2 * N)
            + rng.integers(0, 256, N, dtype=np.uint8).tobytes()
            + _words(rng, max(n - 7 * N, 0)))
    return data[:n]


def synthetic_parse(rng, n: int):
    """A committed parse (cj, off) of n positions with literal runs over 60
    and over 256 bytes, copies of every length 4-64 with near and far
    offsets, and a block-opening literal."""
    cj = np.full(N, -1, np.int32)
    off = rng.integers(0, N, N).astype(np.int32)
    pos, lit = 0, True
    while pos < n:
        if lit:
            run = int(rng.choice([1, 5, 61, 70, 257, 300]))
            cj[pos:min(pos + run, n)] = 1
            pos += run
        else:
            j = int(rng.integers(4, 65))
            if pos + j > n:
                cj[pos:n] = 1
                break
            cj[pos] = j
            off[pos] = int(rng.choice([1, 3, 2047, 2048, 40000]))
            pos += j
        lit = not lit
    return cj, off


def matcher_edge_rows(seed: int = SEED + 7):
    """Encoder rows at the matcher's tile edges: a row of twelve 10-byte
    words from a small vocabulary (equal propagation values at different
    positions and offsets: ties), random rows with 70-byte copies planted
    to start at each halo and tile edge (t0 - 204, t0 - 203, t0 - 143,
    t0 - 127, t0 - 68, t0 - 64, t0 - 1, t0, t0 + 1, t0 + 63, t0 + 67, t0 +
    68 around tile starts t0 = k x matcher.TILE) and at n = N, one at n = a tile
    boundary and one past it, text at n = 20 tiles and one past, a byte
    run over a tile boundary, and the wrap row (last 68 bytes = first 68).
    Returns (blocks (8, N) uint8, n (8,) int32)."""
    rng = np.random.default_rng(seed)
    vocab = rng.integers(97, 123, (12, 10), dtype=np.uint8)
    ties = []
    while sum(map(len, ties)) < N:
        ties.append(vocab[int(rng.integers(0, 12))])
        ties.append(rng.integers(32, 48, int(rng.integers(1, 4)),
                                 dtype=np.uint8))
    ties = np.concatenate(ties)[:N]
    edges = (-204, -203, -143, -127, -68, -64, -1, 0, 1, 63, 67, 68)
    planted = rng.integers(0, 256, N, dtype=np.uint8)
    for k in range(1, N // matcher.TILE + 1):
        at = k * matcher.TILE + edges[k % len(edges)]
        src = at - int(rng.integers(100, 3000))
        if src >= 0 and at + 70 <= N:
            planted[at:at + 70] = planted[src:src + 70]
    text = np.frombuffer(make_data(2 * N, SEED + 3)[:N], np.uint8)
    run = rng.integers(0, 256, N, dtype=np.uint8)
    for k in range(1, 36, 5):
        t0 = k * matcher.TILE
        run[t0 - 150:t0 + 90] = run[t0 - 151]
    wrap = rng.integers(0, 256, N, dtype=np.uint8)
    wrap[-68:] = wrap[:68]
    last = (N // matcher.TILE) * matcher.TILE
    rows = [(ties, N), (planted, N), (planted, last), (planted, last + 1),
            (text, 20 * matcher.TILE), (text, 20 * matcher.TILE + 1),
            (run, N), (wrap, N)]
    blocks = np.zeros((len(rows), N), np.uint8)
    for i, (row, n) in enumerate(rows):
        blocks[i, :n] = row[:n]
    return blocks, np.array([n for _, n in rows], np.int32)


#: Integer operations a position needs after the sticky stage: 16 link
#: compares, 3 phases, the 16-wide filter, 7 propagation levels, lazy and
#: the jump.
LATER_STAGE_OPS = 72


def matcher_ops(cands: torch.Tensor, sticky: str) -> int:
    """Integer operations the matcher function needs on this (B, N, K)
    table, as the wide kernel computes it (the keep sets after l levels
    are the intersections of the original sets over windows of 2^l
    positions 4 apart, the bucket masks compose by AND): per position the
    K bucket bits of its mask, 3 a sticky level (the bucket test, the mask
    AND, the select) and LATER_STAGE_OPS; at "exact", for each level's
    default that passes the bucket test, the compares its window needs: at
    each of its 2^l positions in turn the keeps up to the one equal to it,
    all K where none is (and then no further position); at "sig" the
    verification's compares likewise at the position itself, where the
    default is not keep 0. Raises AssertionError where the sticky offsets
    this walk gives differ from the plain composition's."""
    b, n, k = cands.shape
    iota = torch.arange(n, device=cands.device)
    bits = torch.where(cands != 0, encode._sig_bit(cands), 0)
    mask = functools.reduce(torch.bitwise_or, bits.unbind(-1))
    del bits
    d = cands[..., 0]
    total = b * n * (k + 3 * encode.STICKY_LEVELS + LATER_STAGE_OPS)

    def scan(at, x):
        eq = at == x[..., None]
        hit = eq.any(-1)
        return torch.where(hit, eq.to(torch.int8).argmax(-1) + 1, k), hit

    for lvl in range(encode.STICKY_LEVELS):
        s = 4 << lvl
        edge = iota < s
        x = torch.roll(d, s, dims=1)
        take = (x != 0) & ((mask & encode._sig_bit(x)) != 0) & ~edge
        if sticky == "exact":
            for i in range(1 << lvl):
                length, hit = scan(torch.roll(cands, 4 * i, dims=1), x)
                total += int(torch.where(take, length, 0).sum())
                take &= hit
        d = torch.where(take, x, d)
        mask = torch.where(edge, mask, torch.roll(mask, s, dims=1) & mask)
    if sticky == "sig":
        length, hit = scan(cands, d)
        need = (d != 0) & (d != cands[..., 0])
        total += int(torch.where(need, length, 0).sum())
        d = torch.where(hit & (d != 0), d, cands[..., 0])
    if not torch.equal(d, encode._sticky_offsets(cands, sticky)):
        raise AssertionError("the window-intersection sticky walk differs "
                             "from the plain composition")
    return total


def wide_mask(cands: torch.Tensor, sticky: str) -> torch.Tensor:
    """(B, N) int64: each position's 32-bit bucket mask (encode._sig_bit)
    as the wide kernel's mask pass builds it: of all K keeps at "exact",
    zero keeps included (there it only prefilters), of the nonzero keeps at
    "sig"."""
    bits = encode._sig_bit(cands)
    if sticky == "sig":
        bits = torch.where(cands != 0, bits, 0)
    return functools.reduce(torch.bitwise_or, bits.unbind(-1))


#: The near bits the wide kernel's mask pass computes at "exact": whether
#: keep 0 of the position 4u back, u = 1..NEAR, is one of a position's
#: keeps (csrc/matcher.cu, kNear).
NEAR = 3


def wide_sticky(cands: torch.Tensor, sticky: str = "exact"):
    """The wide matcher kernel's sticky stage as it walks (csrc/matcher.cu,
    "The wide form") on a (B, N, K) table. Each default carries its origin
    m: it is keep 0 of the position 4m back. At each level the candidate x
    from i - s, of origin r = s / 4 + m, moves to i when the position's
    composed mask admits it (the AND of the wide_mask bucket masks over
    the window) and, at "exact", when it lies in the table at every window
    position i - 4j, j < 2^l: there it is keep 0 of the position 4(r - j)
    back, which the near bits answer for r - j <= NEAR; else keep 0, else
    a scan of keeps 1..K-1 (for an asker no near bit has rejected). At
    "sig" a default that is not keep 0 is verified by a scan of the
    position's own keeps, falling back to keep 0. Returns (the sticky
    offsets, counts): `admitted` defaults, `near` tests (a bit each),
    `tests` at keep 0, and `scans`."""
    b, n, k = cands.shape
    iota = torch.arange(n, device=cands.device)
    c0 = cands[..., 0]
    d = c0.clone()
    org = torch.zeros_like(d)
    mask = wide_mask(cands, sticky)
    if sticky == "exact":
        near = torch.stack([
            (torch.roll(c0, 4 * u, dims=1) != 0)
            & (cands == torch.roll(c0, 4 * u, dims=1)[..., None]).any(-1)
            for u in range(1, NEAR + 1)], dim=-1)
    counts = dict.fromkeys(("admitted", "near", "tests", "scans"), 0)
    for lvl in range(encode.STICKY_LEVELS):
        s = 4 << lvl
        edge = iota < s
        x = torch.roll(d, s, dims=1)
        ox = torch.roll(org, s, dims=1) + s // 4
        take = (x != 0) & ((mask & encode._sig_bit(x)) != 0) & ~edge
        counts["admitted"] += int(take.sum())
        if sticky == "exact":
            alive = take.clone()
            need, hits = [], []
            for j in range(1 << lvl):
                at = torch.roll(cands, 4 * j, dims=1)
                u = ox - j
                by_bit = take & (u <= NEAR)
                bit = torch.gather(torch.roll(near, 4 * j, dims=1), -1,
                                   (u.clamp(1, NEAR) - 1)[..., None])[..., 0]
                counts["near"] += int(by_bit.sum())
                counts["tests"] += int((take & ~by_bit).sum())
                alive &= ~by_bit | bit
                need.append(take & ~by_bit & (at[..., 0] != x))
                hits.append((at[..., 1:] == x[..., None]).any(-1))
            for want, hit in zip(need, hits):
                want = want & alive
                counts["scans"] += int(want.sum())
                alive &= ~want | hit
            take = alive
        d = torch.where(take, x, d)
        org = torch.where(take, ox, org)
        mask = torch.where(edge, mask, torch.roll(mask, s, dims=1) & mask)
    if sticky == "sig":
        want = (d != 0) & (d != c0)
        ok = (cands[..., 1:] == d[..., None]).any(-1)
        counts["scans"] += int(want.sum())
        d = torch.where((d == 0) | (want & ~ok), c0, d)
    return d, counts


def wide_lane_map(k: int, t0: int) -> np.ndarray:
    """The wide kernel's unpacked mask pass as an index map: for the tile
    starting at output t0, the flat offset (position * K + column) into a
    row's (N, K) table of every entry each (step, thread, read) takes.
    Four neighbouring lanes share a region position, a step covers
    THREADS / 4 positions; at K % 4 == 0 lane h reads the 16-byte words h,
    h + 4, ... of its position, else the entries h, h + 4, ... The region
    starts LEFT positions before t0 and wraps at the row's end (tile 0).
    Returns an int64 array (steps, THREADS, reads) with -1 where a lane
    reads nothing."""
    threads, length = matcher.THREADS, matcher.THREADS * matcher.PER
    per_step = threads // 4
    steps = length // per_step
    if k % 4 == 0:
        words = -(-(k // 4) // 4)
        reads = 4 * words
    else:
        reads = -(-k // 4)
    out = np.full((steps, threads, reads), -1, np.int64)
    for step in range(steps):
        for tid in range(threads):
            r = step * per_step + tid // 4
            h = tid % 4
            g = (t0 - matcher.LEFT + r) % N
            if k % 4 == 0:
                cols = [4 * i + c for i in range(h, k // 4, 4)
                        for c in range(4)]
            else:
                cols = list(range(h, k, 4))
            out[step, tid, :len(cols)] = [g * k + c for c in cols]
    return out


def emit_edge_parses(seed: int = SEED + 8):
    """Committed parses (cj, off, block, n) at the emission's tile edges: an
    incompressible row (one 65536-byte literal run: every tile's run end
    comes from the last tile or from n); literal runs of 60, 61, 256 and
    257 starting or ending on tile boundaries and half-tile points
    (multiples of emit.TILE / 2), between copies; 3-byte copies starting
    one and two positions before such a point (at tile boundaries their
    2nd and 3rd header bytes ride the next tile's first positions; one
    before and two before alternate from tile to tile) and element starts
    exactly at tile starts; a literal run cut by n = 50000; an all-copy row; and a
    block-opening literal followed by the synthetic mix of long runs and
    far copies. Returns numpy arrays (8, N) int32, (8, N) int32, (8, N)
    uint8, (8,) int32."""
    rng = np.random.default_rng(seed)
    rows = []
    half = emit.TILE // 2

    def copies(cj, off, start, stop, far=False):
        pos = start
        while pos + 4 <= stop:
            j = int(rng.integers(4, min(64, stop - pos) + 1))
            cj[pos] = j
            off[pos] = int(rng.integers(2048, 40000)) if far else int(
                rng.integers(1, 2048))
            pos += j
        cj[pos:stop] = 1
        return cj

    def row():
        return np.full(N, -1, np.int32), rng.integers(0, N, N).astype(
            np.int32)

    cj, off = row()
    cj[:] = 1
    rows.append((cj, off, N))
    for lens in ((60, 61, 256, 257), (257, 256, 61, 60)):
        cj, off = row()
        pos, k = 0, 0
        for b in range(half, N, half):
            run = lens[k % 4]
            start = b if k % 2 == 0 else b - run  # starts or ends at b
            if start < pos + 4:
                continue
            copies(cj, off, pos, start)
            cj[start:start + run] = 1
            pos, k = start + run, k + 1
        copies(cj, off, pos, N)
        rows.append((cj, off, N))
    cj, off = row()
    pos = 0
    for b in range(half, N, half):
        at = b - 1 - (b // emit.TILE) % 2  # one or two before the point
        copies(cj, off, pos, at, far=True)
        cj[at] = int(rng.integers(12, 65))  # a 3-byte copy
        off[at] = int(rng.integers(2048, 40000))
        pos = at + int(cj[at])
        cj[at + 1:pos] = -1
    copies(cj, off, pos, N)
    rows.append((cj, off, N))
    cj, off = row()
    copies(cj, off, 0, 49900)
    cj[49900:50000] = 1
    rows.append((cj, off, 50000))
    cj, off = row()
    cj[::4] = 4
    rows.append((cj, off, N))
    cj, off = synthetic_parse(rng, N - 3)
    rows.append((cj, off, N - 3))
    cj, off = row()
    cj[:300] = 1
    copies(cj, off, 300, 40000, far=True)
    rows.append((cj, off, N))
    cj = np.stack([r[0] for r in rows])
    off = np.stack([r[1] for r in rows])
    n = np.array([r[2] for r in rows], np.int32)
    iota = np.arange(N)
    cj = np.where(iota[None] < n[:, None], cj, -1).astype(np.int32)
    block = rng.integers(0, 256, (len(rows), N), dtype=np.uint8)
    return cj, off, block, n


def tiled_resolve_rows(rows: int, seed: int = SEED + 9):
    """(lit, src), (rows, 65536) int32 each, for the tiled resolves: the
    map kinds below (all with src[p] <= p) cycled over the rows, lit random
    bytes. Every lane pointing at 0; chains that cross every tile, one hop
    a tile (tiles - 1 hops, at the 4096 and the 1024 tile); each tile's
    lanes pointing just left of it (at both tiles); the period-1 chain,
    65535 deep; the identity (at its fixed point); random decreasing
    pointers; short random hops; sparse 7-hops; pointers into the first
    64 lanes; random short copies around a 10000-deep chain."""
    rng = np.random.default_rng(seed)
    ident = np.arange(N, dtype=np.int64)
    mixed = ident.copy()
    copies = rng.choice(np.arange(1, N), 20000, replace=False)
    mixed[copies] = np.maximum(copies - rng.integers(1, 64, 20000), 0)
    mixed[40000:50000] = np.arange(40000, 50000) - 1
    kinds = np.stack([
        np.zeros(N, np.int64),
        np.maximum(ident - tiledres.TILE, 0),
        np.maximum(ident - tiledres.DEPTH_TILE, 0),
        np.maximum(ident - ident % tiledres.TILE - 1, 0),
        np.maximum(ident - ident % tiledres.DEPTH_TILE - 3, 0),
        np.maximum(ident - 1, 0),
        ident,
        np.minimum(ident, rng.integers(0, N, N)),
        np.maximum(ident - rng.integers(1, 300, N), 0),
        np.where(rng.random(N) < 0.5, ident, np.maximum(ident - 7, 0)),
        np.minimum(ident, rng.integers(0, 64, N)),
        mixed]).astype(np.int32)
    src = kinds[np.arange(rows) % len(kinds)]
    lit = rng.integers(0, 256, (rows, N)).astype(np.int32)
    return lit, src


def next_start_edge_rows(m: int) -> np.ndarray:
    """(rows, m) bool flags at next_start_block's span edges: for every
    span end e inside the row (a multiple of scans.SPAN) and every end of
    its read-ahead (e + scans.AHEAD), one row whose only set flag sits at
    e - 1, at e and at e + 1; a row set only at m - 1; and an all-zero
    row. For m < SPAN the row's end is the only span end."""
    edges = sorted({p for e in range(scans.SPAN, m, scans.SPAN)
                    for c in (e, e + scans.AHEAD)
                    for p in (c - 1, c, c + 1) if 0 <= p < m} | {m - 1})
    rows = np.zeros((len(edges) + 1, m), bool)
    rows[np.arange(len(edges)), edges] = True
    return rows


#: The `resolved` flags resolve_tiled is held at: none given, every row
#: flagged (most maps are not at their fixed point), every other row.
RESOLVED_KINDS = ("none", "all", "alternate")


def resolved_flags(kind: str, rows: int):
    """(rows,) bool flags of a RESOLVED_KINDS kind, or None for "none"."""
    if kind == "none":
        return None
    if kind == "all":
        return np.ones(rows, bool)
    return np.arange(rows) % 2 == 0


#: The root flags resolve_tiled_flag is held at: exact (flags[p] = 1 iff
#: src[p] is a fixed point, what "flagtail" computes), over-approximate
#: (also 1 on about half the unresolved lanes, which stops tiles early),
#: all zero (every round runs) and under-approximate (the exact flags with
#: about half the set ones cleared: exact bytes after more rounds, in
#: which some lanes' flags change while their pointers stay).
FLAG_KINDS = ("exact", "over", "zero", "under")


def root_flags(kind: str, src: np.ndarray, seed: int = SEED + 11):
    """(rows, 65536) int32 root flags of a FLAG_KINDS kind for src."""
    exact = np.take_along_axis(src, src, axis=-1) == src
    if kind == "over":
        rng = np.random.default_rng(seed)
        exact |= rng.random(src.shape) < 0.5
    elif kind == "zero":
        exact[:] = False
    elif kind == "under":
        rng = np.random.default_rng(seed)
        exact &= rng.random(src.shape) < 0.5
    return exact.astype(np.int32)


#: The depths resolve_tiled_depth is held at, from each tile's exact local
#: depth: exact, over- and under-declared, all 0, above the kernel's cap
#: of 11, negative, and a random mix of all of them.
DEPTH_KINDS = ("exact", "over", "under", "zero", "above", "negative",
               "mixed")


def depth_variant(kind: str, exact: np.ndarray, seed: int = SEED + 10):
    """(rows, 64) int32 depths of a DEPTH_KINDS kind, from `exact` (what
    tiledres.tile_depths_plain gives)."""
    rng = np.random.default_rng(seed)
    shape = exact.shape
    return {"exact": exact,
            "over": exact + rng.integers(1, 6, shape),
            "under": np.maximum(exact - rng.integers(1, 4, shape), 0),
            "zero": np.zeros(shape),
            "above": rng.integers(12, 40, shape),
            "negative": rng.integers(-5, 0, shape),
            "mixed": rng.integers(-2, 15, shape)}[kind].astype(np.int32)


#: The destination rows place_block is held at (place_edge_rows).
PLACE_KINDS = ("lane", "shuffled", "duplicates", "random", "clamped",
               "empty", "seam")


def _lane(rng, m: int) -> np.ndarray:
    """An emission-shaped lane: nondecreasing destinations from 0 in
    steps of 1 or 2, a third of the positions inactive (emit.SENT)."""
    active = rng.random(m) < 2 / 3
    step = np.where(rng.random(m) < 0.8, 1, 2) * active
    return np.where(active, np.cumsum(step) - 1, emit.SENT)


def place_edge_rows(rows: int, m: int = N, out_rows: int = 528,
                    seed: int = SEED + 11):
    """(dest, vals), (rows, m) int32 each (m a multiple of 2048), for
    place_block at out_rows (cells = out_rows * 128): the PLACE_KINDS
    cycled over the rows, vals random bytes. An emission-shaped lane;
    source tiles in shuffled order, each on its own span of 3000 cells
    anywhere in the row (non-monotone: a source tile meets output tiles
    far from its neighbours'); each tile on 16 cells (duplicates summed);
    random destinations over the whole row and past both its ends
    (negatives and those at or past the cells inactive, most active ones
    dropped and counted); tiles whose least destination lies in the last
    window, which the clamp to out_rows - 32 anchors (the partial last
    4096-cell output tile among its cells); no kept write (SENT and
    negatives only); and two lanes side by side whose destinations
    restart at the seam (placement "kernel")."""
    rng = np.random.default_rng(seed)
    cells = out_rows * 128
    tiles = m // 1024
    span = np.sort(rng.integers(0, 3000, (tiles, 1024)), axis=1)
    shuffled = (rng.permutation(tiles) * ((cells - 3000) // tiles))[:, None]
    window = cells - 32 * 128
    kinds = {
        "lane": _lane(rng, m),
        "shuffled": (shuffled + span).reshape(m),
        "duplicates": (shuffled + rng.integers(0, 16, (tiles, 1024)))
        .reshape(m),
        "random": rng.integers(-200, cells + 200, m),
        "clamped": np.where(rng.random(m) < 0.9,
                            rng.integers(window, cells, m),
                            rng.integers(cells, cells + 64, m)),
        "empty": np.where(rng.random(m) < 0.5, emit.SENT, -1),
        "seam": np.concatenate([_lane(rng, m // 2), _lane(rng, m // 2)]),
    }
    dest = np.stack([kinds[PLACE_KINDS[r % len(PLACE_KINDS)]]
                     for r in range(rows)]).astype(np.int32)
    vals = rng.integers(0, 256, (rows, m)).astype(np.int32)
    return dest, vals


#: The window height the windowed scatter is held at for each limb count
#: (limb_rows): the encoder placement's at one limb, a sidecar bucket at
#: two, the transport's at three.
LIMB_WROWS = {1: 32, 2: 72, 3: 192}
#: out_cells it is held at: half a block, a block, place_block's 528 rows.
OUT_CELLS = (32768, N, 67584)


def limb_rows(limbs: int, cells: int, m: int = 8192):
    """(dest, vals), (3, m) int32 each, for scatter_windowed at `limbs`
    onto `cells` at LIMB_WROWS[limbs]: near-monotone destinations (steps
    of 1-2, 30% dropped at `cells`, tag/payload pairs summing in one
    cell), random destinations that overflow their windows, and a row
    whose first tile spans more than its window (counted once) and whose
    other tiles lie in the last window (the clamp). Values up to
    2^(8 limbs), the top limb's headroom, and -1 (the top limb
    unmasked)."""
    rng = np.random.default_rng(limbs * 1000 + cells // 128)
    mono = np.minimum(np.cumsum(rng.integers(1, 3, m)), cells)
    mono = np.where(rng.random(m) < 0.3, cells, mono)
    mono[1::2] = np.where(rng.random(m // 2) < 0.1, mono[::2], mono[1::2])
    rand = rng.integers(0, cells + 1, m)
    last = rng.integers(cells - 128 * LIMB_WROWS[limbs], cells + 1, m)
    last[:1024] = cells
    last[0], last[1023] = 0, cells - 1
    dest = np.stack([mono, rand, last]).astype(np.int32)
    vals = rng.integers(0, (1 << (8 * limbs)) + 1, dest.shape)
    vals[:, ::5] = -1
    return dest, vals.astype(np.int32)
