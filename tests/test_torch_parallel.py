"""The port's data-parallel layer (tpu_snappy_torch/parallel/) and framing's
mesh against the JAX package's on its 8-device virtual CPU mesh.

The port's virtual CPU mesh of 8 shards plays the 8 forced host devices
(tests/conftest.py). On the same seeded input (Zipf word text, a one-byte
run, corpus.synth random ASCII, random bytes, a partial last block):
shard.encode_dp equals JAX shard.encode_dp on its 8-device mesh and the
port's 1-shard mesh, also for an input of fewer blocks than shards;
decode_dp gives the input back, also from the C++ golden's stream;
streaming.compress_stream on 20 blocks + 5 bytes in waves of 8 writes 3
waves and encode_dp's bytes, a resumed stream equals an uninterrupted one;
the multihost entry points run in one process; framing.compress(...,
mesh=) equals JAX framing.compress(..., mesh=mesh8) under every sidecar
policy, and its decodes take the same chunks down the same paths with and
without the mesh; sidecar.decode_corpus_sidecar equals decode_chunks wave
by wave. Mirrors tests/test_parallel.py and tests/test_aux.py with
synthetic inputs. The `gpu` tests run the sharded paths on the card.
"""

import io

import jax
import pytest
import torch

from tpu_snappy import framing as JF
from tpu_snappy.parallel import mesh as jmeshlib, shard as jshard

from tpu_snappy_torch import api, framing as TF, reference_codec
from tpu_snappy_torch import format as fmt
from tpu_snappy_torch import sidecar as sc
from tpu_snappy_torch.native import golden
from tpu_snappy_torch.parallel import mesh as meshlib
from tpu_snappy_torch.parallel import multihost, shard, streaming
from torch_edges import block_mix
from torch_threads import share_cores

share_cores()

B = fmt.BLOCK_SIZE
POLICIES = ("off", "auto", "always")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def jax_mesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return jmeshlib.make_mesh(8)


@pytest.fixture(scope="module")
def mesh8():
    return meshlib.make_mesh(8, device="cpu")


@pytest.fixture(scope="module")
def data():
    return block_mix(10 * B + 1234)


@pytest.fixture(scope="module")
def streams(data, mesh8, jax_mesh8):
    """The port's encode_dp stream on 8 shards and JAX's on 8 devices."""
    return shard.encode_dp(data, mesh8), jshard.encode_dp(data, jax_mesh8)


def test_mesh_shape(mesh8, monkeypatch):
    assert mesh8.size == 8
    assert mesh8.devices == (torch.device("cpu"),) * 8
    assert mesh8.world == 1 and mesh8.rank == 0 and mesh8.group is None
    rows = meshlib.shard_rows(mesh8, 16)
    assert [r for _d, r in rows] == [slice(2 * i, 2 * i + 2)
                                     for i in range(8)]
    with pytest.raises(ValueError, match="split"):
        meshlib.shard_rows(mesh8, 12)
    four = meshlib.make_mesh(device=("cpu",) * 4)
    assert four.size == 4 and meshlib.make_mesh(2, device=("cpu",) * 4).size \
        == 2
    assert meshlib.make_mesh(device="cpu").size == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        meshlib.make_mesh(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        meshlib.make_mesh(device=("cuda:0",) * 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        streaming.compress_stream(io.BytesIO(b"x"), io.BytesIO(), 1)


def test_layout_is_the_jax_padding():
    """The JAX package's rule (whole waves of min(wave, share) a shard), at
    the API's wave: one short wave for small jobs, API_WAVE rows after."""
    for count, ndev in ((1, 8), (11, 8), (11, 1), (20, 8), (256, 4),
                        (17, 3), (100, 1), (300, 1), (1000, 4)):
        per = -(-count // ndev)
        wave = min(api.API_WAVE, per)
        assert shard.layout(count, ndev) == (
            wave, (-(-per // wave) * wave) * ndev)
    assert shard.layout(300, 1) == (128, 384) and api.API_WAVE == 128


def test_encode_dp_matches_jax_and_one_shard(data, streams):
    mine, theirs = streams
    assert mine == theirs
    assert mine == shard.encode_dp(data, meshlib.make_mesh(1, device="cpu"))
    assert reference_codec.decompress(mine) == data


def test_blocks_of_matches_jax(data):
    for size, padded in ((B, 16), (20000, 40)):
        mine = shard.blocks_of(data, size, padded)
        theirs = jshard.blocks_of(data, size, padded)
        assert (mine[0] == theirs[0]).all() and mine[2] == theirs[2]
        assert (mine[1] == theirs[1]).all()


def test_encode_dp_small_input(mesh8, jax_mesh8):
    """Fewer blocks than shards: the padding rows vanish from the output.
    No small-input host path: the device pipeline's stream, as in JAX."""
    tiny = b"hello hello hello hello " * 10
    comp = shard.encode_dp(tiny, mesh8)
    assert comp == jshard.encode_dp(tiny, jax_mesh8)
    assert reference_codec.decompress(comp) == tiny


def test_decode_dp_round_trip(data, streams, mesh8):
    assert shard.decode_dp(streams[0], mesh8) == data
    foreign = (golden.compress(data) if golden.available()
               else reference_codec.compress(data))
    assert shard.decode_dp(foreign, mesh8) == data
    assert shard.decode_dp(fmt.varint_encode(0), mesh8) == b""


@pytest.fixture(scope="module")
def data20():
    return block_mix(20 * B + 5)


@pytest.fixture(scope="module")
def stream20(data20, mesh8):
    return shard.encode_dp(data20, mesh8)


def test_streaming_compress(data20, stream20, mesh8):
    src, dst = io.BytesIO(data20), io.BytesIO()
    stats = streaming.compress_stream(src, dst, len(data20), mesh8,
                                      blocks_per_wave=8)
    comp = dst.getvalue()
    assert stats.in_bytes == len(data20) and stats.out_bytes == len(comp)
    assert stats.waves == 3  # 20.0001 blocks in waves of 8
    assert stats.ratio == len(data20) / len(comp)
    assert comp == stream20


def test_streaming_resume(data20, stream20, mesh8):
    """Interrupted after wave 1 (8 blocks), then resumed from its stats."""
    part = io.BytesIO()
    streaming.compress_stream(io.BytesIO(data20[:8 * B]), part, 8 * B, mesh8,
                              blocks_per_wave=8)
    resumed = io.BytesIO()
    resumed.write(fmt.varint_encode(len(data20)))
    resumed.write(part.getvalue()[fmt.varint_size(8 * B):])
    src = io.BytesIO(data20)
    src.seek(8 * B)
    stats = streaming.StreamStats(in_bytes=8 * B, out_bytes=resumed.tell(),
                                  waves=1)
    out = streaming.compress_stream(src, resumed, len(data20), mesh8,
                                    blocks_per_wave=8, resume=stats)
    assert resumed.getvalue() == stream20
    assert out.waves == 3 and out.in_bytes == len(data20)


def test_streaming_rejects_misaligned_resume_and_short_reads():
    mesh = meshlib.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="whole number of waves"):
        streaming.compress_stream(
            io.BytesIO(b"x" * 100), io.BytesIO(), 100, mesh,
            blocks_per_wave=2,
            resume=streaming.StreamStats(in_bytes=1, out_bytes=1, waves=0))
    with pytest.raises(IOError, match="short read"):
        streaming.compress_stream(io.BytesIO(b"x" * 100), io.BytesIO(), 200,
                                  mesh)


def test_multihost_entry_points_single_process(data, streams):
    assert multihost.global_mesh(device="cpu").size == 1
    assert multihost.compress_dp_global(data, device="cpu") == streams[1]
    dst = io.BytesIO()
    stats = multihost.compress_multihost(
        io.BytesIO(data), dst, len(data), blocks_per_wave=8, device="cpu")
    assert dst.getvalue() == streams[1]
    assert stats.out_bytes == len(dst.getvalue()) and stats.waves == 2


@pytest.fixture(scope="module")
def framed(data, mesh8, jax_mesh8):
    """Per policy: the port's framed stream on 8 shards and JAX's on its
    8-device mesh."""
    return {p: (TF.compress(data, sidecar=p, mesh=mesh8),
                JF.compress(data, mesh=jax_mesh8, sidecar=p))
            for p in POLICIES}


@pytest.mark.parametrize("policy", POLICIES)
def test_framed_mesh_matches_jax(data, framed, mesh8, policy):
    mine, theirs = framed[policy]
    assert mine == theirs
    assert mine == TF.compress(data, sidecar=policy, device="cpu")
    got, stats = TF.decompress_with_stats(mine, mesh=mesh8)
    plain, pstats = TF.decompress_with_stats(mine, device="cpu")
    assert got == plain == data
    for k in ("root_map", "hinted", "normal", "host", "redecoded_root_map",
              "redecoded_hinted", "uncompressed"):
        assert getattr(stats, k) == getattr(pstats, k), k
    compressed = sum(1 for t, _o, _n in TF._parse_chunks(mine)
                     if t == TF.CHUNK_COMPRESSED)
    assert stats.root_map + stats.hinted + stats.normal == compressed
    if policy == "auto" and golden.available():
        assert stats.hinted and stats.root_map  # both sidecars in use
    if policy == "always":
        assert stats.root_map
    assert TF.decompress(mine, use_sidecar=False, mesh=mesh8) == data
    dst = io.BytesIO()
    n = TF.decompress_stream(io.BytesIO(mine), dst, mesh=mesh8,
                             chunks_per_wave=3)
    assert dst.getvalue() == data and n == len(data)


def test_framed_stream_with_mesh(data, framed, mesh8):
    dst = io.BytesIO()
    n = TF.compress_stream(io.BytesIO(data), dst, len(data), sidecar="auto",
                           mesh=mesh8, blocks_per_wave=4)
    assert dst.getvalue() == framed["auto"][0] and n == len(dst.getvalue())


def test_decode_corpus_sidecar_matches_decode_chunks(data):
    """The root maps of the "always" stream's chunks, packed and padded to
    whole waves: the wave-mapped decode equals decode_chunks wave by wave,
    and a chunk count that is not a multiple of the wave raises."""
    fr = TF.compress(data[:8 * B], sidecar="always", device="cpu")
    bodies = [(t, fr[o:o + n]) for t, o, n in TF._parse_chunks(fr)]
    units = []
    for (t, side), (_t2, body) in zip(bodies, bodies[1:]):
        if t == TF.CHUNK_SIDECAR:
            ulen, elems = TF._head(body)
            starts, vals, wrows = sc.prep_parent(*sc.parse(side), ulen)
            units.append((elems, ulen, starts, vals))
    assert len(units) >= 4
    wave = 3
    arrays = [torch.from_numpy(a) for a in sc.pack_batch(
        units, pad_rows=-len(units) % wave)]
    out, ok = sc.decode_corpus_sidecar(*arrays, wave=wave, wrows=512)
    for s in range(0, len(out), wave):
        o, k = sc.decode_chunks(*(a[s:s + wave] for a in arrays), wrows=512)
        assert torch.equal(out[s:s + wave], o) and torch.equal(ok[s:s + wave],
                                                               k)
    for j, (_e, ulen, _s, _v) in enumerate(units):
        assert ok[j]
    with pytest.raises(ValueError, match="multiple of the wave"):
        sc.decode_corpus_sidecar(*(a[:wave + 1] for a in arrays), wave=wave)


@pytest.mark.gpu
def test_sharded_paths_on_the_card(data, streams, framed, cuda):
    one = meshlib.make_mesh(1)
    four = meshlib.make_mesh(device=(cuda,) * 4)
    for mesh in (one, four):
        comp = shard.encode_dp(data, mesh)
        assert comp == streams[0]
        assert shard.decode_dp(comp, mesh) == data
    dst = io.BytesIO()
    stats = streaming.compress_stream(io.BytesIO(data), dst, len(data), four,
                                      blocks_per_wave=4)
    assert dst.getvalue() == streams[0] and stats.waves == 3
    for policy in POLICIES:
        fr = TF.compress(data, sidecar=policy, mesh=four)
        assert fr == framed[policy][0]
        assert TF.decompress(fr, mesh=one) == data
