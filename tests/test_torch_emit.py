"""The port's single-lane emission (ops/kernels/emit.py) against JAX.

The committed parse (cj = committed ? jump : -1) and offsets of the rows
of test_torch_encode.py go through emit_block_single's plain version (the
CPU path) and through the Pallas `emit_block_single` in interpret mode:
pm, pa, pb, head and total must be equal exactly; so must the two-lane
emit_block's plain version and the Pallas `emit_block` (pack_a, pack_b,
total). The overflow compaction and placement built on them are held by
the stream tests of test_torch_encode.py. The `gpu` tests hold the CUDA
kernels against their plain versions on the card.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_snappy.ops.pallas import emit as PE
from tpu_snappy.ops.pallas import place as PP

from tpu_snappy_torch.config import DEFAULT_CONFIG
from tpu_snappy_torch.ops import encode as TE
from tpu_snappy_torch.ops import scan as TS
from tpu_snappy_torch.ops.kernels import emit as KE

from test_torch_encode import _inputs

from torch_threads import share_cores

from torch_edges import emit_edge_parses, synthetic_parse

share_cores()

N = 1 << 16


@pytest.fixture(scope="module")
def parse():
    """(cj, off, blocks, n) of every row of test_torch_encode._inputs."""
    blocks, lens = _inputs()
    b, n = torch.from_numpy(blocks), torch.from_numpy(lens)
    pref, words = TE._candidate_offsets(TE._window_keys(b, n), n)
    jump, off = TE._matcher.matcher_block_packed(
        pref, words, n, DEFAULT_CONFIG.candidates, DEFAULT_CONFIG.lazy)
    iota = torch.arange(N, dtype=torch.int32)
    cj = torch.where(TS.commit_bounded(jump) & (iota < n[:, None]), jump, -1)
    return cj, off, b, n


def test_emit_constants():
    assert KE.SENT == PE.SENT == PP.SENT == TE.SENT
    assert KE.N == PE.N == N
    assert KE.HEAD == PE.LANES


# Random bytes (literal runs over 60 and 256), the RLE pattern, and the
# far-copy / long-literal mix (test_pallas.py:496-499).
@pytest.mark.parametrize("row", [1, 2, 3])
def test_emit_plain_matches_pallas_interpret(parse, row):
    cj, off, b, n = parse
    got = KE.emit_block_single(cj[row:row + 1], off[row:row + 1],
                               b[row:row + 1], n[row:row + 1])
    want = PE.emit_block_single(jnp.asarray(cj[row].numpy()),
                                jnp.asarray(off[row].numpy()),
                                jnp.asarray(b[row].numpy()),
                                jnp.int32(int(n[row])))
    pm, pa, pb, head, total = (x[0].numpy() for x in got)
    wpm, wpa, wpb, whead, wtotal = (np.asarray(x) for x in want)
    assert (pm == wpm.view(np.int32)).all()
    assert (pa == wpa.view(np.int32)).all()
    assert (pb == wpb.view(np.int32)).all()
    assert (head == whead.view(np.int32)).all()
    assert int(total) == int(wtotal)


def test_emit_block_plain_matches_pallas_interpret(parse):
    """Two-lane emission of the far-copy / long-literal mix: 3-byte copies
    and literal headers of 2 and 3 bytes ride lane A."""
    cj, off, b, n = parse
    row = 3
    pa, pb, total = KE.emit_block(cj[row:row + 1], off[row:row + 1],
                                  b[row:row + 1], n[row:row + 1])
    wpa, wpb, wtotal = PE.emit_block(jnp.asarray(cj[row].numpy()),
                                     jnp.asarray(off[row].numpy()),
                                     jnp.asarray(b[row].numpy()),
                                     jnp.int32(int(n[row])))
    assert (pa[0].numpy() == np.asarray(wpa).view(np.int32)).all()
    assert (pb[0].numpy() == np.asarray(wpb).view(np.int32)).all()
    assert int(total[0]) == int(wtotal)


def test_emit_overflow_and_head_fire(parse):
    """The rows exercise every lane: literal runs over 60 and over 256
    bytes (pb and pa), and a block-opening literal (head)."""
    cj, off, b, n = parse
    pm, pa, pb, head, total = KE.emit_block_single(cj, off, b, n)
    assert (pa != 0).any() and (pb != 0).any()
    assert (head[:, 0] != KE.SENT << 8).any()
    assert (head[:, 1:] == KE.SENT << 8).all()
    assert (total[n == 0] == 0).all()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_emit_kernel_matches_plain(parse, cuda):
    args = tuple(x.to(cuda) for x in parse)
    got = KE.emit_block_single(*args)
    want = KE.emit_block_single_plain(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.gpu
def test_emit_block_kernel_matches_plain(parse, cuda):
    rng = np.random.default_rng(7)
    lens = [N, N - 1, 1000, 300]
    syn = [synthetic_parse(rng, m) for m in lens]
    cases = [parse, (torch.from_numpy(np.stack([c for c, _ in syn])),
                     torch.from_numpy(np.stack([o for _, o in syn])),
                     torch.from_numpy(rng.integers(0, 256, (len(lens), N),
                                                   dtype=np.uint8)),
                     torch.tensor(lens, dtype=torch.int32))]
    for case in cases:
        args = tuple(x.to(cuda) for x in case)
        got = KE.emit_block(*args)
        want = KE.emit_block_plain(*args)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


# --- The kernel's tiles and look-back (csrc/emit.cu), in torch --------------
#
# The CUDA emission cuts a row into tiles: a summary gives each tile's first
# element start and its first start after the tile's first position; a
# tile's run ends are its in-tile suffix-min and the later tiles' first
# starts; its output offset and literal-base carry come from the earlier
# tiles' (sum, latest run base) by a look-back; each position reads its
# two predecessors and its successor across tile edges from the tile's own
# numbers. The form below is that design, written out tile by tile.

def _lit(c):
    return (c >= 0) & (c < 4)


def _tiled_emit(cj, off, block, n, tile: int):
    """Single and two-lane packs from the tile restatement: ((pm, pa, pb,
    head, total), (pack_a, pack_b, total))."""
    b = cj.shape[0]
    tiles = N // tile
    cj, off, n = cj.long(), off.long(), n.long()[:, None]
    prev = torch.cat([torch.full((b, 1), -1), cj[:, :-1]], 1)
    elem = (cj >= 4) | (_lit(cj) & ~_lit(prev))
    e = torch.where(elem, torch.arange(N), N).view(b, tiles, tile)
    first = e.min(-1).values                        # summary: first start
    after0 = e[:, :, 1:].min(-1).values             # first after t0
    hdr = lambda ll: torch.where(ll <= 60, 1, torch.where(ll <= 256, 2, 3))
    tag = lambda ll: torch.where(ll <= 60, (ll - 1) << 2,
                                 torch.where(ll <= 256, 60 << 2, 61 << 2))
    small = lambda c, o: (c <= 11) & (o < 2048)
    ctag = lambda c, o: torch.where(small(c, o), 1 | (c - 4) << 2 |
                                    (o >> 8) << 5, 2 | (c - 1) << 2)
    outs = [torch.zeros((b, N), dtype=torch.int64) for _ in range(5)]
    head = torch.full((b, 128), emit_sent(), dtype=torch.int64)
    prefix = torch.zeros((b, 1), dtype=torch.int64)
    carry = torch.zeros((b, 1), dtype=torch.int64)
    for t in range(tiles):
        t0 = t * tile
        later = first[:, t + 1:].min(-1, keepdim=True).values \
            if t + 1 < tiles else torch.full((b, 1), N)
        # Positions t0 - 2 .. t0 + tile, column 0 = t0 - 2.
        span = torch.arange(t0 - 2, t0 + tile + 1)
        inside = (span >= 0) & (span < N)
        idx = span.clamp(0, N - 1)
        c = torch.where(inside, cj[:, idx], -1)
        o = torch.where(inside, off[:, idx], 0)
        cp = torch.where(span >= 1, cj[:, (span - 1).clamp(0, N - 1)], -1)
        el = (c >= 4) | (_lit(c) & ~_lit(cp))
        # Run ends: the in-tile suffix-min past each position, then the
        # later tiles' first starts; t0 - 2, t0 - 1 from the tile's own.
        est = torch.where(el[:, 2:-1], span[2:-1], N)
        suf = est.flip(-1).cummin(-1).values.flip(-1)
        run = torch.cat([suf[:, 1:], torch.full((b, 1), N)], 1)
        run = torch.minimum(run, later)
        r1 = torch.minimum(suf[:, :1], later)        # for t0 - 1
        r2 = torch.where(el[:, 1:2], t0 - 1, r1)     # for t0 - 2
        nxt = torch.minimum(after0[:, t + 1:t + 2], first[:, t + 2:].min(
            -1, keepdim=True).values) if t + 2 < tiles else (
            after0[:, t + 1:t + 2] if t + 1 < tiles else torch.full((b, 1), N))
        ends = torch.cat([r2, r1, run, nxt], 1)
        ll = torch.clamp(torch.minimum(ends, n) - span, min=1)
        esz = torch.where(el, torch.where(c >= 4, torch.where(
            small(c, o), 2, 3), hdr(ll) + ll), 0)
        local = torch.cumsum(esz[:, 2:-1], 1) - esz[:, 2:-1]
        oo = torch.cat([-(esz[:, 1:2] + esz[:, :1]), -esz[:, 1:2], local,
                        local[:, -1:] + esz[:, -2:-1]], 1) + prefix
        ls = _lit(c) & ~_lit(cp)
        base = torch.where(ls, oo + hdr(ll) - span, 0)
        last = torch.where(ls[:, 2:-1], torch.arange(tile), -1).cummax(
            1).values
        v = torch.where(last >= 0, torch.gather(base[:, 2:-1], 1,
                                                last.clamp(min=0)), carry)
        if (last[:, -1] >= 0).any():
            carry = torch.where(last[:, -1:] >= 0, v[:, -1:], carry)
        prefix = prefix + esz[:, 2:-1].sum(1, keepdim=True)
        i = span[2:-1]
        cc, oc, lc, ooc = c[:, 2:-1], o[:, 2:-1], ll[:, 2:-1], oo[:, 2:-1]
        cm1, cm2 = c[:, 1:-2], c[:, :-3]
        om1, om2 = o[:, 1:-2], o[:, :-3]
        byte = block[:, t0:t0 + tile].long()
        sent = torch.full_like(cc, 1 << 20)
        is_lit = _lit(cc)
        lt0c = (i + 1 < N) & ~is_lit & _lit(c[:, 3:])
        md = torch.where(is_lit, v + i, torch.where(cc >= 4, ooc, torch.where(
            cm1 >= 4, oo[:, 1:-2] + 1, torch.where(
                (cm2 >= 4) & ~small(cm2, om2), oo[:, :-3] + 2, torch.where(
                    lt0c, oo[:, 3:], sent)))))
        mv = torch.where(is_lit, byte, torch.where(cc >= 4, ctag(cc, oc),
             torch.where(cm1 >= 4, om1, torch.where(
                 (cm2 >= 4) & ~small(cm2, om2), om2 >> 8, torch.where(
                     lt0c, tag(ll[:, 3:]), 0)))))
        lsc, n1 = ls[:, 2:-1], lc - 1
        outs[0][:, t0:t0 + tile] = md << 8 | (mv & 0xFF)
        outs[1][:, t0:t0 + tile] = torch.where(
            lsc & (hdr(lc) == 3), (ooc + 2) << 8 | (n1 >> 8 & 0xFF), 0)
        outs[2][:, t0:t0 + tile] = torch.where(
            lsc & (hdr(lc) >= 2), (ooc + 1) << 8 | (n1 & 0xFF), 0)
        # Two lanes: A the tags and the 2nd / 3rd header bytes, B payload.
        elc = el[:, 2:-1]
        e1 = (i >= 1) & el[:, 1:-2]
        e2 = (i >= 2) & el[:, :-3]
        ll1 = torch.where(i >= 1, ll[:, 1:-2], 1)
        ll2 = torch.where(i >= 2, ll[:, :-3], 1)
        hdr1 = torch.where(cm1 >= 4, torch.where(small(cm1, om1), 2, 3),
                           hdr(ll1))
        hdr2 = torch.where(cm2 >= 4, torch.where(small(cm2, om2), 2, 3),
                           hdr(ll2))
        t1 = torch.where(cm1 >= 4, om1, ll1 - 1)
        t2 = torch.where(i >= 2, torch.where(cm2 >= 4, om2, ll2 - 1) >> 8, 0)
        ad = torch.where(elc, ooc, torch.where(e1 & (hdr1 >= 2), oo[:, 1:-2]
                                               + 1, torch.where(
            e2 & (hdr2 >= 3), oo[:, :-3] + 2, sent)))
        av = torch.where(elc, torch.where(cc >= 4, ctag(cc, oc), tag(lc)),
                         torch.where(e1 & (hdr1 >= 2), t1, t2))
        outs[3][:, t0:t0 + tile] = ad << 8 | (av & 0xFF)
        outs[4][:, t0:t0 + tile] = torch.where(is_lit, v + i, sent) << 8 \
            | byte
        if t == 0:
            head[:, 0] = torch.where(ls[:, 2], tag(ll[:, 2]) & 0xFF,
                                     emit_sent())
    total = prefix[:, 0].to(torch.int32)
    i32 = [x.to(torch.int32) for x in outs]
    return ((i32[0], i32[1], i32[2], head.to(torch.int32), total),
            (i32[3], i32[4], total))


def emit_sent() -> int:
    return KE.SENT << 8


def _edge_parses():
    return tuple(torch.from_numpy(x) for x in emit_edge_parses())


def test_emit_tile_and_scratch():
    """The wrapper's tile is the kernel's (csrc/emit.cu: kPer x kThreads
    positions), a row holds a whole number of tiles, at most 32 (one
    look-back lane a predecessor), and the scratch is four int32 a tile
    and one ticket."""
    src = (pathlib.Path(KE.__file__).parent / "csrc" / "emit.cu").read_text()
    per, threads = (int(re.search(rf"constexpr int {name} = (\d+);",
                                  src).group(1))
                    for name in ("kPer", "kThreads"))
    assert KE.TILE == per * threads == 2048
    assert N % KE.TILE == 0 and N // KE.TILE <= 32
    assert KE.scratch_ints(128) == 128 * 4 * 32 + 1
    assert KE.scratch_ints(3) == 3 * 4 * 32 + 1


def test_emit_tiles_restated_match_plain(parse):
    """The tile restatement gives both plain versions' bits on the edge
    parses (a 65536-byte literal run, runs of 60/61/256/257 on tile
    boundaries, 3-byte copies whose header bytes cross into the next tile,
    n inside a run, an all-copy row, a block-opening literal) and on the
    encoder's rows."""
    for args in (_edge_parses(), parse):
        single, two = _tiled_emit(*args, KE.TILE)
        want = KE.emit_block_single_plain(*args)
        assert all(torch.equal(g, w) for g, w in zip(single, want))
        want = KE.emit_block_plain(*args)
        assert all(torch.equal(g, w) for g, w in zip(two, want))


@pytest.mark.parametrize("row", [0, 2, 3])
def test_emit_tiles_restated_match_pallas_interpret(row):
    """The incompressible row, the runs on boundaries and the copies that
    cross them, against the Pallas kernels interpreted on the CPU."""
    cj, off, b, n = (x[row:row + 1] for x in _edge_parses())
    (pm, pa, pb, head, total), (la, lb, total2) = _tiled_emit(
        cj, off, b, n, KE.TILE)
    want = PE.emit_block_single(jnp.asarray(cj[0].numpy()),
                                jnp.asarray(off[0].numpy()),
                                jnp.asarray(b[0].numpy()), jnp.int32(int(n[0])))
    for g, w in zip((pm, pa, pb, head), want[:4]):
        assert (g[0].numpy() == np.asarray(w).view(np.int32)).all()
    assert int(total[0]) == int(want[4])
    wa, wb, wt = PE.emit_block(jnp.asarray(cj[0].numpy()),
                               jnp.asarray(off[0].numpy()),
                               jnp.asarray(b[0].numpy()), jnp.int32(int(n[0])))
    assert (la[0].numpy() == np.asarray(wa).view(np.int32)).all()
    assert (lb[0].numpy() == np.asarray(wb).view(np.int32)).all()
    assert int(total2[0]) == int(wt)


@pytest.mark.parametrize("name", ["emit_block_single", "emit_block"])
@pytest.mark.parametrize("arg", [0, 1, 2])
def test_emit_refuses_misaligned_tensors(monkeypatch, name, arg):
    """The kernels load cj, off and the bytes 16 bytes a thread: a view that
    does not start on a 16-byte boundary is refused before any launch (the
    CUDA path's checks, run here on CPU tensors with the launch stubbed)."""
    def no_launch():
        raise AssertionError("launched")
    monkeypatch.setattr(KE._build, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(KE._build, "lib", no_launch)
    args = [torch.zeros((2, N), dtype=torch.int32),
            torch.zeros((2, N), dtype=torch.int32),
            torch.zeros((2, N), dtype=torch.uint8),
            torch.full((2,), N, dtype=torch.int32)]
    with pytest.raises(AssertionError, match="launched"):
        getattr(KE, name)(*args)
    x = args[arg]
    args[arg] = torch.zeros(x.numel() + 16, dtype=x.dtype)[1:1 + x.numel()] \
        .view(x.shape)
    assert args[arg].is_contiguous() and args[arg].data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        getattr(KE, name)(*args)


@pytest.mark.gpu
def test_emit_kernels_match_plain_on_edge_parses(parse, cuda):
    """Both emission kernels on the edge parses, on the encoder's rows and
    on the synthetic mix."""
    rng = np.random.default_rng(11)
    syn = [synthetic_parse(rng, m) for m in (N, N - 1, 1000)]
    mix = (torch.from_numpy(np.stack([c for c, _ in syn])),
           torch.from_numpy(np.stack([o for _, o in syn])),
           torch.from_numpy(rng.integers(0, 256, (3, N), dtype=np.uint8)),
           torch.tensor([N, N - 1, 1000], dtype=torch.int32))
    for case in (_edge_parses(), parse, mix):
        args = tuple(x.to(cuda) for x in case)
        got = KE.emit_block_single(*args)
        want = KE.emit_block_single_plain(*args)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        got = KE.emit_block(*args)
        want = KE.emit_block_plain(*args)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
