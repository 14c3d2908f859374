"""The port's encoder at the JAX package's presets against the JAX encoder:
the shared inputs and checks, and the tests that span presets.

FAST (K=8), TURBO (K=3, sticky "sig") and ULTRA (TURBO at stride 2) run
the packed matcher at odd K and at "sig". Each preset has a test file of
its own (tests/test_torch_presets_fast.py, _turbo.py, _ultra.py), so that
a run with one worker per file spreads them. There, on seeded rows (text,
byte runs, random bytes, a row planted with signature collisions, and the
two blocks of a 70 KB input) the port's encode_blocks at every placement
must equal tpu_snappy.ops.encode.encode_blocks at the same config byte
for byte (the JAX suite proves its CPU route equal to its TPU route and
to its "sort" placement); the packed candidate form must equal the JAX
packed form; api.compress must equal the JAX api.compress, and every
stream must round-trip through the port and the host codecs; the framed
stream under ULTRA with sidecar "auto" must equal the JAX framed stream.
The `gpu` tests repeat the encode on the card. Here: the presets are the
JAX presets, and every placement gives the bytes of "sort".
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_snappy import api as jax_api
from tpu_snappy import config as JC
from tpu_snappy import reference_codec
from tpu_snappy.ops import encode as E

from tpu_snappy_torch import api
from tpu_snappy_torch import config as TC
from tpu_snappy_torch.ops import decode as TD
from tpu_snappy_torch.ops import encode as TE

from torch_threads import share_cores

share_cores()

N = 1 << 16
PRESETS = {"fast": (JC.FAST_CONFIG, TC.FAST_CONFIG),
           "turbo": (JC.TURBO_CONFIG, TC.TURBO_CONFIG),
           "ultra": (JC.ULTRA_CONFIG, TC.ULTRA_CONFIG)}


def _sig_bucket_pairs():
    """Offset pairs (a, b), a < b < 2048, whose signature bits collide."""
    x = np.arange(1, 2048, dtype=np.uint64)
    bucket = ((x * 0x9E3779B1) & 0xFFFFFFFF) >> 27
    pairs = []
    for b in range(32):
        members = x[bucket == b]
        pairs.append((int(members[1]), int(members[2])))
    return pairs


def sig_collision_row(seed: int = 5):
    """A random row with planted signature collisions: at each planted p,
    the window at p-4 occurs only a bytes back and the window at p only b
    bytes back, with sig(a) == sig(b). At K=3 the signature composition
    carries p-4's default a into p, where a is no candidate; only the
    final exact verification falls back to b. Returns (row, plants)."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, 256, N, dtype=np.uint8)
    pairs = _sig_bucket_pairs()
    plants = []
    for p in range(3000, 60000, 2500):
        a, b = pairs[int(rng.integers(0, len(pairs)))]
        w1, w2, other = (rng.integers(0, 256, 4, dtype=np.uint8)
                         for _ in range(3))
        row[p - 4 - a:p - a] = w1
        row[p - a:p - a + 4] = other
        row[p - b:p - b + 4] = w2
        row[p - 4:p] = w1
        row[p:p + 4] = w2
        plants.append((p, a, b))
    return row, plants


def data_70k() -> bytes:
    """70 KB, two blocks: phrase text, a zero run, random bytes, text."""
    rng = np.random.default_rng(31)
    text = b"Sing, O goddess, the anger of Achilles son of Peleus. " * 800
    return (text[:30000] + bytes(12000) + bytes(rng.integers(0, 256, 8000,
                                                             "u1"))
            + text[5000:25000])


def rows():
    """(blocks (6, N) uint8, lengths (6,) int32): text, an `ab` ladder
    with random bytes, random bytes, the signature-collision row, and the
    two blocks of data_70k()."""
    rng = np.random.default_rng(13)
    datas = [b"The quick brown fox jumps over the lazy dog. " * 1500,
             b"ab" * 8000 + bytes(rng.integers(0, 256, 4000, "u1")),
             bytes(rng.integers(0, 256, 20000, "u1")),
             sig_collision_row()[0].tobytes()]
    d70 = data_70k()
    datas += [d70[:N], d70[N:]]
    blocks = np.zeros((len(datas), N), np.uint8)
    lens = np.zeros(len(datas), np.int32)
    for i, d in enumerate(datas):
        lens[i] = min(len(d), N)
        blocks[i, :lens[i]] = np.frombuffer(d[:lens[i]], np.uint8)
    return blocks, lens


def jax_encode(preset: str):
    """JAX (out, out_lens) of rows() at a preset, as numpy."""
    blocks, lens = rows()
    out, out_lens = E.encode_blocks(jnp.asarray(blocks), jnp.asarray(lens),
                                    PRESETS[preset][0])
    return np.asarray(out), np.asarray(out_lens)


def check_encode_blocks(want: tuple, preset: str, placement: str,
                        device="cpu") -> None:
    """The port's encode_blocks of rows() at a preset and placement, on
    `device`, equals JAX's (out, out_lens) `want`."""
    blocks, lens = rows()
    out, out_lens = TE.encode_blocks(torch.from_numpy(blocks).to(device),
                                     torch.from_numpy(lens).to(device),
                                     PRESETS[preset][1], placement)
    want, want_lens = want
    assert (out_lens.cpu().numpy() == want_lens).all(), placement
    assert out.shape == want.shape
    assert (out.cpu().numpy() == want).all(), placement


def test_port_presets_are_the_jax_presets():
    for jcfg, tcfg in PRESETS.values():
        assert repr(jcfg) == repr(tcfg)
    assert TE.PLACEMENTS == ("auto", "winplace", "single", "emit", "sort",
                             "kernel")


def check_odd_k_packed_form(preset: str) -> None:
    """At odd K every half of the (K-1)/2 words is a slot (no flattening
    offset in a high half), at stride 2 the form is expanded with zero
    rows; both must equal the JAX packed form exactly."""
    jcfg, tcfg = PRESETS[preset]
    blocks, lens = rows()
    b, n = torch.from_numpy(blocks), torch.from_numpy(lens)
    s = tcfg.stride
    key = (TE._window_keys(b, n) if s == 1
           else TE._window_keys_strided(b, n, s))
    pref, words = TE._candidate_offsets(key, n, tcfg)
    k = tcfg.candidates

    def one(block, length):
        kiota = jnp.arange(0, N, s, dtype=jnp.int32)
        jkey = (E._window_keys(block, length, kiota) if s == 1
                else E._window_keys_strided(block, length, s))
        return E._candidate_offsets(jkey, length, kiota, k, jcfg.flatten,
                                    jcfg.probes, packed=True, stride=s)

    jp, jw = jax.jit(jax.vmap(one))(jnp.asarray(blocks), jnp.asarray(lens))
    assert words.shape == (len(lens), k // 2, N)
    assert (pref.numpy() == np.asarray(jp)).all()
    assert (words.numpy() == np.asarray(jw).transpose(0, 2, 1)
            .view(np.int32)).all()


def _structured(seed: int) -> bytes:
    """Seeded structures in the spirit of tests/test_fuzz.py's
    structured_bytes: runs, repeated phrases at varying distances, random
    bytes and short alphabets, concatenated up to one block."""
    rng = np.random.default_rng(seed)
    parts, total = [], 0
    while total < N - 300:
        kind = int(rng.integers(0, 4))
        size = int(rng.integers(1, 300))
        if kind == 0:
            part = bytes([int(rng.integers(0, 256))]) * size
        elif kind == 1 and parts:
            part = parts[int(rng.integers(0, len(parts)))][:size]
        elif kind == 2:
            part = bytes(rng.integers(0, 256, size, "u1"))
        else:
            part = bytes(rng.integers(97, 101, size, "u1"))
        parts.append(part)
        total += len(part)
    return b"".join(parts)[:N]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_every_placement_equals_sort(seed):
    """tests/test_fuzz.py:104-123 mirrored: on seeded structures every
    placement gives the bytes of "sort", at DEFAULT and at TURBO."""
    data = [_structured(seed), _structured(seed + 100)[:int(seed * 9000)]]
    blocks = np.zeros((2, N), np.uint8)
    lens = np.array([len(d) for d in data], np.int32)
    for i, d in enumerate(data):
        blocks[i, :len(d)] = np.frombuffer(d, np.uint8)
    b, n = torch.from_numpy(blocks), torch.from_numpy(lens)
    for cfg in (TC.DEFAULT_CONFIG, TC.TURBO_CONFIG):
        want, want_lens = TE.encode_blocks(b, n, cfg, "sort")
        for placement in TE.PLACEMENTS:
            out, out_lens = TE.encode_blocks(b, n, cfg, placement)
            assert torch.equal(out_lens, want_lens), placement
            assert torch.equal(out, want), placement


def api_streams(preset: str):
    """(port stream, JAX stream) of data_70k() via api.compress."""
    jcfg, tcfg = PRESETS[preset]
    data = data_70k()
    return (api.compress(data, tcfg, device="cpu"),
            jax_api.compress(data, jcfg))


def check_api_round_trip(preset: str, comp: bytes) -> None:
    """The port's stream of data_70k() at a preset round-trips through
    the port (on the device path) and the host codecs."""
    data = data_70k()
    tcfg = PRESETS[preset][1]
    got, stats = api.decompress_with_stats(comp, tcfg, device="cpu")
    assert got == data
    assert stats.path == "device" and stats.spliced == 0
    assert reference_codec.decompress(comp) == data
    golden = TD.native_golden()
    if golden is not None:
        assert golden.uncompress(comp) == data
