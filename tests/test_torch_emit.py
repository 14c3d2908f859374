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


def _synthetic_parse(rng, n: int):
    """A committed parse (cj, off) of n positions with literal runs over 60
    and over 256 bytes, copies of every length 4-64 with near and far
    offsets, a block-opening literal, and random offsets where no copy
    starts."""
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


@pytest.mark.gpu
def test_emit_block_kernel_matches_plain(parse, cuda):
    rng = np.random.default_rng(7)
    lens = [N, N - 1, 1000, 300]
    syn = [_synthetic_parse(rng, m) for m in lens]
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
