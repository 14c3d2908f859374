"""The port's framed decode sidecars (tpu_snappy_torch/sidecar.py) against
tpu_snappy/sidecar.py.

The host halves (root-map pieces, payloads, parsing, splitting, piece
values, window buckets, widths, batch packing, depth hints) must give the
JAX module's values; decode_chunks (scatter_windowed at the sidecar's
`wrows`, forward fill, a 1-limb gather_block) must give the bytes and ok
flags of sidecar.decode_chunks_jit in split mode and in parent-direct mode.
scatter_windowed's `wrows` is held against the Pallas kernel at every
PARENT_WROWS bucket, an overflowing tile included; as on the TPU (and not
on the JAX CPU path), a piece start that overflows the window makes its
chunk not-ok. Inputs are synthetic: text, runs, random bytes, random
tokens. The `gpu`
test runs decode_chunks on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_snappy import api as jax_api
from tpu_snappy import format as fmt
from tpu_snappy import sidecar as JSC
from tpu_snappy.ops.pallas import scatter as PS

from tpu_snappy_torch import sidecar as SC
from tpu_snappy_torch.ops.kernels import scatter as KS

from torch_threads import share_cores

share_cores()

N = 1 << 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _classes():
    rng = np.random.default_rng(7)
    vocab = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
             for _ in range(300)]
    return [
        ("tinytext", b"The quick brown fox jumps over the lazy dog. " * 100),
        ("xrle", b"x" * 50000),
        ("abrle", b"ab" * 20000),
        ("random", rng.integers(0, 256, 30000, dtype=np.uint8).tobytes()),
        ("tokens", b"".join(vocab[i] for i in rng.integers(0, 300, 4000))
         [:60000]),
    ]


@pytest.fixture(scope="module")
def chunks():
    """(name, data, elems, ulen) of one-chunk streams of every class, from
    the JAX encoder (the port's is byte-identical, test_torch_api)."""
    out = []
    for name, data in _classes():
        comp = jax_api.compress(data, small_fastpath=False)
        total, start = fmt.varint_decode(comp)
        out.append((name, data, comp[start:], total))
    return out


def test_constants_match_jax():
    for k in ("MAGIC", "CHUNK_TYPE", "DEPTH_CHUNK_TYPE", "DEPTH_MAGIC",
              "SPLIT_LEN", "MAX_PIECES", "PARENT_WROWS", "OUT"):
        assert getattr(SC, k) == getattr(JSC, k), k


def test_host_halves_match_jax(chunks):
    for name, _data, elems, ulen in chunks:
        assert SC.build(elems, ulen) == JSC.build(elems, ulen), name
        mine, theirs = SC._root_pieces_py(elems, ulen), \
            JSC._root_pieces_py(elems, ulen)
        for a, b, c in zip(mine, theirs, SC._root_pieces(elems, ulen)):
            assert (np.asarray(a) == np.asarray(b)).all(), name
            assert (np.asarray(a) == np.asarray(c)).all(), name
        payload = SC.build(elems, ulen)
        parsed, jparsed = SC.parse(payload), JSC.parse(payload)
        for a, b in zip(parsed, jparsed):
            assert (a == b).all(), name
        for a, b in zip(SC.split_for_device(*parsed, ulen),
                        JSC.split_for_device(*jparsed, ulen)):
            assert (a == b).all(), name
        assert (SC.parent_vals(*parsed) == JSC.parent_vals(*jparsed)).all()
        assert SC.parent_wrows(parsed[0]) == JSC.parent_wrows(jparsed[0])
        mine, theirs = SC.prep_parent(*parsed, ulen), \
            JSC.prep_parent(*jparsed, ulen)
        assert (mine[1] == theirs[1]).all() and mine[2] == theirs[2]
        assert SC.build_depth(elems, ulen) == JSC.build_depth(elems, ulen)
        d = SC.build_depth(elems, ulen)
        if d is not None:
            assert (SC.parse_depth(d) == JSC.parse_depth(d)).all()
    for total in (0, 1, 4096, 4097, 40000, 99999):
        assert SC.pieces_width(total) == JSC.pieces_width(total)
        assert SC.elems_width(total) == JSC.elems_width(total)
    assert SC.prep_parent(np.array([0, 70]), np.array([0, 1]),
                          np.array([1, 1]), 50) is None
    jobs = [(c[2], c[3], *SC.prep_parent(*SC.parse(SC.build(c[2], c[3])),
                                         c[3])[:2]) for c in chunks]
    for a, b in zip(SC.pack_batch(jobs, pad_rows=3),
                    JSC.pack_batch(jobs, pad_rows=3)):
        assert (a == b).all()


def test_malformed_payloads_are_ignored(chunks):
    """A malformed, foreign or other-pipeline sidecar parses to None, in
    both packages alike."""
    _name, _data, elems, ulen = chunks[2]
    good = SC.build_depth(elems, ulen)
    assert good is not None and SC.parse_depth(good) is not None
    bad = bytearray(good)
    bad[4] ^= 1  # tail_cap mismatch
    payload = SC.build(elems, ulen)
    rng = np.random.default_rng(5)
    for junk in (bytes(bad), b"tpD1" + b"\0" * 8, b"", good[:-1],
                 payload[:-1], b"tpS1" + bytes(4), payload[:8] + b"\xaa",
                 rng.integers(0, 256, 40, dtype=np.uint8).tobytes()):
        assert SC.parse_depth(junk) is None and JSC.parse_depth(junk) is None
        if junk[:4] != b"tpD1":
            assert SC.parse(junk) is None and JSC.parse(junk) is None


@pytest.fixture(scope="module")
def batches(chunks):
    """Split-mode and parent-direct batches of all classes at one width."""
    split, parent, wrows = [], [], SC.PARENT_WROWS[0]
    for _name, _data, elems, ulen in chunks:
        parsed = SC.parse(SC.build(elems, ulen))
        split.append((elems, ulen, *SC.split_for_device(*parsed, ulen)))
        starts, vals, w = SC.prep_parent(*parsed, ulen)
        parent.append((elems, ulen, starts, vals))
        wrows = max(wrows, w)
    return SC.pack_batch(split), SC.pack_batch(parent), wrows


@pytest.mark.parametrize("mode", ["split", "parent"])
def test_decode_chunks_matches_jax(chunks, batches, mode):
    e, s, v, u = batches[0] if mode == "split" else batches[1]
    wrows = None if mode == "split" else batches[2]
    out, ok = SC.decode_chunks(_t(e), _t(s), _t(v), _t(u), wrows=wrows)
    jout, jok = JSC.decode_chunks_jit(e, s, v, u, wrows=wrows)
    assert ok.numpy().all() and np.asarray(jok).all()
    assert (out.numpy() == np.asarray(jout)).all()
    for j, (name, data, _e, ulen) in enumerate(chunks):
        assert out[j, :ulen].numpy().tobytes() == data, name
        assert not out[j, ulen:].any(), name


def test_decode_chunks_window_overflow_is_not_ok(chunks, batches):
    """At the smallest bucket the token chunk's 1024-piece tiles span more
    than the window, which drops piece starts: that chunk is not-ok (the
    JAX CPU path, which has no window, cannot see it); the others decode."""
    e, s, v, u = batches[1]
    counts = KS.scatter_windowed(_t(s), _t(v), SC.PARENT_WROWS[0])[1]
    out, ok = SC.decode_chunks(_t(e), _t(s), _t(v), _t(u),
                               wrows=SC.PARENT_WROWS[0])
    assert (ok.numpy() == (counts.numpy() == 0)).all()
    names = [c[0] for c in chunks]
    assert not ok[names.index("tokens")] and ok[names.index("xrle")]
    for j, good in enumerate(ok.numpy()):
        if good:
            assert out[j, :chunks[j][3]].numpy().tobytes() == chunks[j][1]


def _scatter_cases(wrows: int):
    """Piece-start rows: ascending starts with gaps that fit `wrows`, gaps
    that overflow it in one tile, and padding (65536, dropped)."""
    rng = np.random.default_rng(wrows)
    m = 8192
    step = max(1, (wrows - 9) * 128 // 1024)
    fit = np.minimum(np.cumsum(rng.integers(1, step + 1, m)), N)
    wide = fit.copy()
    wide[1024:2048] = np.minimum(1024 * step + np.arange(1024) * 160, N - 1)
    wide[2048:] = np.maximum(wide[2048:], wide[2047] + 1)
    pad = fit.copy()
    pad[m // 2:] = N
    dest = np.stack([fit, np.minimum(wide, N), pad]).astype(np.int32)
    vals = rng.integers(1, 1 << 18, dest.shape).astype(np.int32)
    return dest, vals


@pytest.mark.parametrize("wrows", [*JSC.PARENT_WROWS, PS.WROWS])
def test_scatter_windowed_wrows_matches_pallas(wrows):
    dest, vals = _scatter_cases(wrows)
    out, ovf = KS.scatter_windowed(_t(dest), _t(vals), wrows)
    for row in range(len(dest)):
        want, wovf = PS.scatter_windowed(jnp.asarray(dest[row]),
                                         jnp.asarray(vals[row]), 3, N,
                                         wrows=wrows)
        assert (out[row].numpy() == np.asarray(want)).all(), (wrows, row)
        assert int(ovf[row]) == int(wovf), (wrows, row)
    assert int(ovf[0]) == 0 and int(ovf[2]) == 0
    assert (int(ovf[1]) > 0) == (wrows < N // 128)
    with pytest.raises(ValueError, match="wrows"):
        KS.scatter_windowed(_t(dest), _t(vals), 513)


@pytest.mark.gpu
def test_decode_chunks_on_the_card_matches_cpu(batches, cuda):
    for mode, (e, s, v, u) in (("split", batches[0]), ("parent", batches[1])):
        wrows = None if mode == "split" else batches[2]
        want = SC.decode_chunks(_t(e), _t(s), _t(v), _t(u), wrows=wrows)
        got = SC.decode_chunks(*(_t(a).to(cuda) for a in (e, s, v, u)),
                               wrows=wrows)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want)), mode
    for wrows in JSC.PARENT_WROWS:
        dest, vals = (_t(a).to(cuda) for a in _scatter_cases(wrows))
        got = KS.scatter_windowed(dest, vals, wrows)
        want = KS.scatter_windowed_plain(dest, vals, wrows)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), wrows
