"""The port's one-block and one-fragment entry points and its helpers,
against the JAX package, on the CPU.

ops.encode.encode_block and ops.decode.decode_fragment (tpu_snappy/ops/
encode.py:721, decode.py:292) give JAX's bytes and lengths on streams of
DEFAULT_CONFIG and FAST_CONFIG; decode_fragment with resolve="depthtail"
and the framed 0x81 hints gives decode_fragments_depth's. ops.scan.gather_s,
parallel.shard.pad_count and DP_WAVE, utils.profiling.sync1 and
ops.decode.TAIL_VARIANT stand beside their JAX counterparts. The C++
golden's command-line harness (native.golden.swcompression_path) round
trips a seeded file in both modes, and its streams are golden.compress's;
golden.depth_hints equals the brute-force depth_hints_sim on the port's
own streams at tiles 128 to 65536.
"""

import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_snappy.config import DEFAULT_CONFIG as J_DEFAULT
from tpu_snappy.config import FAST_CONFIG as J_FAST
from tpu_snappy.ops import decode as JD
from tpu_snappy.ops import encode as JE
from tpu_snappy.ops import scan as JS
from tpu_snappy.parallel import shard as JSH
from tpu_snappy.utils import profiling as JP

from tpu_snappy_torch import api
from tpu_snappy_torch import format as fmt
from tpu_snappy_torch.config import DEFAULT_CONFIG, FAST_CONFIG
from tpu_snappy_torch.native import golden
from tpu_snappy_torch.ops import decode as TD
from tpu_snappy_torch.ops import encode as TE
from tpu_snappy_torch.ops import scan as TS
from tpu_snappy_torch.parallel import shard
from tpu_snappy_torch.utils import profiling

from torch_edges import make_data
from torch_threads import share_cores

share_cores()

N = 1 << 16
CONFIGS = {"default": (DEFAULT_CONFIG, J_DEFAULT), "fast": (FAST_CONFIG,
                                                           J_FAST)}
#: Fragment width the decodes run at: the port's and JAX's frag_width of
#: these streams, so one JAX compile serves every fragment.
WIDTH = 5 * 8192


@pytest.fixture(scope="module")
def data():
    return make_data(2 * N + 5000)


def _block(data: bytes, i: int) -> tuple:
    """Block i of data, zero-padded to 65536 bytes, and its length."""
    part = np.frombuffer(data[i * N:(i + 1) * N], np.uint8)
    block = np.zeros(N, np.uint8)
    block[:len(part)] = part
    return block, len(part)


_encode_jit = jax.jit(JE.encode_block, static_argnames=("cfg", "placement"))


@pytest.mark.parametrize("preset", sorted(CONFIGS))
def test_encode_block_matches_jax(data, preset):
    cfg, jcfg = CONFIGS[preset]
    for i in (0, 2):  # a full block and the 5000-byte tail
        block, n = _block(data, i)
        out, out_len = TE.encode_block(block, n, cfg, device="cpu")
        want, want_len = _encode_jit(jnp.asarray(block), jnp.int32(n),
                                     cfg=jcfg)
        assert int(out_len) == int(want_len), (preset, i)
        assert out.shape == (cfg.block_capacity,)
        assert (out.numpy() == np.asarray(want)).all(), (preset, i)
        batch, lens = TE.encode_blocks(torch.from_numpy(block)[None],
                                       torch.tensor([n], dtype=torch.int32),
                                       cfg)
        assert torch.equal(out, batch[0]) and int(lens[0]) == int(out_len)


def _fragments(comp: bytes):
    total, start = fmt.varint_decode(comp)
    frags, clens, ulens = TD.fragment_table(comp, start, total)
    assert TD.frag_width(clens) <= WIDTH
    return frags[:, :WIDTH], clens, ulens


_decode_jit = jax.jit(JD.decode_fragment,
                      static_argnames=("resolve", "fields", "collapse_runs"))


@pytest.mark.parametrize("preset", sorted(CONFIGS))
def test_decode_fragment_matches_jax(data, preset):
    cfg, _ = CONFIGS[preset]
    frags, clens, ulens = _fragments(api.compress(data, cfg, device="cpu"))
    got = []
    for i in range(len(frags)):
        out, ok = TD.decode_fragment(frags[i], clens[i], ulens[i],
                                     device="cpu")
        want, wok = _decode_jit(jnp.asarray(frags[i]), jnp.int32(clens[i]),
                                jnp.int32(ulens[i]))
        assert out.shape == (N,) and out.dtype == torch.uint8
        assert (out.numpy() == np.asarray(want)).all() and bool(ok) == bool(
            wok), (preset, i)
        got.append(out[:ulens[i]].numpy().tobytes())
    assert b"".join(got) == data
    rows, oks, _ = TD.decode_fragments(torch.from_numpy(frags),
                                       torch.from_numpy(clens),
                                       torch.from_numpy(ulens),
                                       resolve="tiled")
    assert torch.equal(TD.decode_fragment(frags[0], clens[0], ulens[0],
                                          "tiled", device="cpu")[0], rows[0])


def test_decode_fragment_with_depths_matches_decode_fragments_depth(data):
    if not golden.available():
        pytest.skip("cmake / Ninja missing: no depth hints")
    comp = api.compress(data, device="cpu")
    frags, clens, ulens = _fragments(comp)
    total, start = fmt.varint_decode(comp)
    offs = np.concatenate([[start], start + np.cumsum(clens)])
    depths = np.stack([golden.depth_hints(comp[offs[i]:offs[i + 1]],
                                          int(ulens[i]), TD.TAIL_CAP,
                                          TD.HINT_TILE)
                       for i in range(len(frags))]).astype(np.int32)
    depths[1] = np.maximum(depths[1] - 2, 0)  # under-declared: wrong bytes
    rows, oks, _ = TD.decode_fragments_depth(
        torch.from_numpy(frags), torch.from_numpy(clens),
        torch.from_numpy(ulens), torch.from_numpy(depths))
    want, wok = JD.decode_fragments_depth_jit(
        jnp.asarray(frags), jnp.asarray(clens), jnp.asarray(ulens),
        jnp.asarray(depths))
    assert (rows.numpy() == np.asarray(want)).all()
    assert (oks.numpy() == np.asarray(wok)).all()
    for i in range(len(frags)):
        out, ok = TD.decode_fragment(frags[i], clens[i], ulens[i],
                                     "depthtail", depths=depths[i],
                                     device="cpu")
        assert torch.equal(out, rows[i]) and bool(ok) == bool(oks[i])
    assert rows[0, :ulens[0]].numpy().tobytes() == data[:N]
    assert rows[1, :ulens[1]].numpy().tobytes() != data[N:2 * N]
    with pytest.raises(ValueError, match="depths"):
        TD.decode_fragment(frags[0], clens[0], ulens[0], "depthtail",
                           device="cpu")


def test_tail_variant_and_the_decoder_tiles():
    assert TD.TAIL_VARIANT == JD.TAIL_VARIANT == "fori"
    assert (TD.TAIL_TILE, TD.HINT_TILE, TD.PARA_TILE) == (
        JD.TAIL_TILE, JD.HINT_TILE, JD.PARA_TILE)


@pytest.mark.parametrize("small", [False, True])
def test_gather_s_matches_jax(small):
    rng = np.random.default_rng(71)
    top = 256 if small else 1 << 20  # JAX's bf16 form is exact below 256
    maps = rng.integers(0, top, (2, 5, TS.S)).astype(np.int32)
    for t in (TS.S, 17):
        idx = rng.integers(-3, TS.S + 5, (2, 5, t)).astype(np.int32)
        got = TS.gather_s(torch.from_numpy(maps), torch.from_numpy(idx),
                          small)
        want = np.asarray(JS.gather_s(jnp.asarray(maps), jnp.asarray(idx),
                                      small))
        assert got.dtype == torch.int32 and (got.numpy() == want).all()
        assert not got[torch.from_numpy(idx >= TS.S)].any()


def test_pad_count_and_dp_wave():
    for count in (0, 1, 7, 8, 9, 255, 256, 1000):
        for n in (1, 2, 3, 4, 8):
            assert shard.pad_count(count, n) == JSH.pad_count(count, n)
    assert shard.DP_WAVE == api.API_WAVE == 128 and JSH.DP_WAVE == 8
    assert shard.layout(1000, 4) == (128, 1024)
    assert shard.layout(10, 4) == (3, 12)


def test_sync1():
    tree = {"a": (torch.arange(4), [torch.zeros(2)]), "b": 3}
    assert profiling.sync1(tree) is None
    assert profiling.sync1([]) is None
    assert JP.sync1({"a": (jnp.arange(4), [jnp.zeros(2)]), "b": 3}) is None


@pytest.fixture(scope="module")
def cli():
    if not golden.available():
        pytest.skip("cmake / Ninja missing: the golden cannot build here")
    path = golden.swcompression_path()
    assert path.exists() and path.parent == golden.BUILD_DIR
    return path


@pytest.mark.parametrize("mode", ["baseline", "dense"])
def test_swcompression_round_trips_and_matches_compress(cli, tmp_path,
                                                        mode):
    data = make_data(150000, seed=72)
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    out = subprocess.run([str(cli), "roundtrip", str(src), mode],
                         capture_output=True, text=True, check=True)
    length, clen = map(int, out.stdout.strip().split(";"))
    want = golden.compress(data, golden.MODE_DENSE if mode == "dense"
                           else golden.MODE_BASELINE)
    assert length == len(data) and clen == len(want) < len(data)
    comp, back = tmp_path / "c.snappy", tmp_path / "back.bin"
    subprocess.run([str(cli), "compress", str(src), str(comp), mode],
                   check=True)
    assert comp.read_bytes() == want
    subprocess.run([str(cli), "uncompress", str(comp), str(back)],
                   check=True)
    assert back.read_bytes() == data


def _streams():
    """The port's own streams: text, a run, random bytes, a periodic block
    and a tiny one (tests/test_sidecar.py:285's kinds)."""
    rng = np.random.default_rng(73)
    pat = bytes(rng.integers(0, 256, 37, dtype=np.uint8))
    return [(b"the cat sat on the mat and a dog sat on the log too "
             * 1300)[:N], b"A" * 50000,
            bytes(rng.integers(0, 256, 4096, dtype=np.uint8)),
            (pat * 1800)[:N], b"xy"]


def test_depth_hints_match_the_simulation():
    if not golden.available():
        pytest.skip("cmake / Ninja missing: the golden cannot build here")
    for data in _streams():
        comp = api.compress(data, device="cpu", small_fastpath=False)
        total, start = fmt.varint_decode(comp)
        elems = comp[start:]
        for cap in (0, 40960, TD.TAIL_CAP, 65537):
            for tile in (128, TD.HINT_TILE, TD.TAIL_TILE, N):
                a = golden.depth_hints(elems, total, cap, tile)
                s = golden.depth_hints_sim(elems, total, cap, tile)
                assert a.shape == (N // tile,)
                assert np.array_equal(a, s), (len(data), cap, tile)
