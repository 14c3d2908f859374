"""The port's dynamic-batching server (tpu_snappy_torch/serving.py) against
tpu_snappy/serving.py.

Counterparts of tests/test_serving.py on the CPU (device="cpu", waves of
1-4 units), with seeded inputs in place of the corpus file: concurrent
round trips equal to the port's API (and so to the JAX package's bytes),
real batching (fewer waves than units), per-request error isolation in a
shared wave, host settlement of exotic streams (only the flagged fragment
re-decoded), the host fast path, the framed container under every
sidecar policy (each wave kind: encode, fragment decode, root-map and
depth-hinted decode), oversize chunks, backpressure, latency stats,
close(), and the pipeline at depths 0, 1 and 3.

Beyond the counterparts: one request mix through the JAX server and the
port's server on the CPU at wave 2 gives the same bytes, the same
exceptions and the same unit count; a 4-shard CPU mesh gives the
one-shard server's bytes; each wave runs on one of PIPELINE_DEPTH worker
threads, that many at once; a failed wave fails only its own requests,
also when one of them spans a later wave; the default device raises with
no card visible. The `gpu` tests hold the server on the card, and on a
mesh of every card, against the API on the card.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from tpu_snappy import serving as jax_serving

from tpu_snappy_torch import api, framing, reference_codec, serving
from tpu_snappy_torch import format as fmt
from tpu_snappy_torch.config import ULTRA_CONFIG
from tpu_snappy_torch.native import golden
from tpu_snappy_torch.ops import decode as ops_decode
from tpu_snappy_torch.parallel import mesh as meshlib
from torch_edges import CORRUPT_STREAM, block_mix, make_data
from torch_threads import share_cores

share_cores()

N = fmt.BLOCK_SIZE
POLICIES = ("off", "auto", "always")
TIMEOUT = 300


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _server(**kw):
    kw.setdefault("device", "cpu")
    return serving.CodecServer(**kw)


def _text(n: int, seed: int = 3) -> bytes:
    """n bytes of the seeded mix (Zipf word text, ASCII, runs)."""
    return make_data(n + 12345, seed)


def _rand(n: int, seed: int = 3) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def _unsnappy(comp: bytes) -> bytes:
    """An independent decoder: the C++ golden where it builds."""
    if golden.available():
        return golden.uncompress(comp)
    return reference_codec.decompress(comp)


def test_concurrent_compress_roundtrip_and_batching():
    payloads = [_text(70_000), _rand(66_000, 1), _text(130_000)[::-1],
                _rand(65_536, 2)]
    with _server(wave=4, max_wait_ms=200) as srv:
        futs = [srv.compress(p) for p in payloads]
        comps = [f.result(timeout=TIMEOUT) for f in futs]
        stats = srv.stats
    for p, c in zip(payloads, comps):
        assert c == api.compress(p, device="cpu")
        assert _unsnappy(c) == p
    # 4 requests -> 7 blocks; wave=4 must have coalesced across requests.
    assert stats.units == 7
    assert stats.waves <= 2
    assert stats.occupancy >= 7 / 8


def test_server_with_speed_preset():
    payloads = [_text(70_000), _rand(66_000, 7)]
    with _server(cfg=ULTRA_CONFIG, wave=4, max_wait_ms=200) as srv:
        comps = [f.result(timeout=TIMEOUT)
                 for f in [srv.compress(p) for p in payloads]]
        backs = [f.result(timeout=TIMEOUT)
                 for f in [srv.decompress(c) for c in comps]]
    for p, c, b in zip(payloads, comps, backs):
        assert c == api.compress(p, ULTRA_CONFIG, device="cpu")
        assert _unsnappy(c) == p
        assert b == p


def test_decompress_batches_and_matches():
    payloads = [_text(100_000), _rand(70_000)]
    comps = [api._host_compress(p) for p in payloads]
    with _server(wave=4, max_wait_ms=200) as srv:
        outs = [f.result(timeout=TIMEOUT)
                for f in [srv.decompress(c) for c in comps]]
        stats = srv.stats
    assert outs == payloads
    assert stats.units == 4 and stats.waves == 1


def test_tiny_requests_host_fastpath():
    with _server(wave=4) as srv:
        outs = [f.result(timeout=60)
                for f in [srv.compress(bytes([i]) * (i + 1))
                          for i in range(20)]]
        backs = [srv.decompress(c).result(timeout=60) for c in outs]
        stats = srv.stats
    assert stats.host_fastpath == 40 and stats.waves == 0
    for i, (c, b) in enumerate(zip(outs, backs)):
        assert _unsnappy(c) == bytes([i]) * (i + 1) == b


def test_error_isolation_in_shared_wave():
    good = _text(80_000)
    with _server(wave=4, max_wait_ms=200) as srv:
        f_good = srv.decompress(api._host_compress(good))
        f_bad = srv.decompress(CORRUPT_STREAM)
        assert f_good.result(timeout=TIMEOUT) == good
        with pytest.raises(ValueError):
            f_bad.result(timeout=TIMEOUT)
        stats = srv.stats
    assert stats.waves == 1  # the two shared one wave


def test_exotic_stream_settles_on_host():
    # A cross-fragment copy (valid; no encoder emits it): the device flags
    # the second fragment and only it re-decodes on the host.
    stream = (b"\x84\x80\x04" + b"\x3c" + b"x" * 16
              + (b"\xfe\x10\x00" * 1023) + b"\xbe\x10\x00"
              + b"\x0e\x10\x00")
    with _server(wave=4, max_wait_ms=100) as srv:
        out = srv.decompress(stream).result(timeout=TIMEOUT)
        stats = srv.stats
    assert out == b"x" * 65540
    assert stats.spliced_fragments == 1


def test_one_bad_fragment_splices_only_itself(monkeypatch):
    # Three fragments at wave=2 with one exotic fragment in the middle:
    # only fragment 1 re-decodes on the host, after the spliced prefix.
    xblock = (b"\x3c" + b"x" * 16 + (b"\xfe\x10\x00" * 1023)
              + b"\xbe\x10\x00")
    frag1 = (b"\x0e\x10\x00" + fmt.literal_header(65532) + b"y" * 65532)
    total = 65536 + 65536 + 100
    stream = (fmt.varint_encode(total) + xblock + frag1
              + fmt.literal_header(100) + b"z" * 100)
    calls = []
    orig = reference_codec.decompress_elements

    def counting(buf, start, end, ctx):
        calls.append(end - start)
        return orig(buf, start, end, ctx)

    monkeypatch.setattr(reference_codec, "decompress_elements", counting)
    with _server(wave=2, max_wait_ms=100) as srv:
        out = srv.decompress(stream).result(timeout=TIMEOUT)
        stats = srv.stats
    assert out == b"x" * 65536 + b"x" * 4 + b"y" * 65532 + b"z" * 100
    assert stats.spliced_fragments == 1
    assert len(calls) == 1
    assert stats.waves >= 2


def test_framed_serving_roundtrip_and_interop():
    payloads = [block_mix(150_000), _rand(70_000, 9) + b"q" * 80_000]
    with _server(wave=4, max_wait_ms=200) as srv:
        frames = [f.result(timeout=TIMEOUT)
                  for f in [srv.compress_framed(p, sidecar="auto")
                            for p in payloads]]
        backs = [srv.decompress_framed(fr).result(timeout=TIMEOUT)
                 for fr in frames]
        fr_sc = srv.compress_framed(payloads[0],
                                    sidecar="always").result(timeout=TIMEOUT)
        back_sc = srv.decompress_framed(fr_sc).result(timeout=TIMEOUT)
        stats = srv.stats
    for p, fr, b in zip(payloads, frames, backs):
        assert b == p
        assert fr == framing.compress(p, sidecar="auto", device="cpu")
        if golden.available():
            assert golden.uncompress_framed(fr, max_out=len(p) + 16) == p
    assert back_sc == payloads[0]
    assert fr_sc == framing.compress(payloads[0], sidecar="always",
                                     device="cpu")
    assert stats.waves_by_kind.get("scd")  # root maps rode their own wave
    if golden.available():  # depth hints need the native simulator
        assert stats.waves_by_kind.get("dcd")
    assert stats.spliced_fragments == 0  # every sidecar passed its CRC


def test_framed_serving_corruption_raises():
    with _server(wave=4, max_wait_ms=100) as srv:
        fr = bytearray(srv.compress_framed(_text(70_000)).result(
            timeout=TIMEOUT))
        ip = len(framing.STREAM_ID)
        while ip < len(fr):  # flip a byte of the first compressed chunk
            ln = int.from_bytes(fr[ip + 1: ip + 4], "little")
            if fr[ip] == framing.CHUNK_COMPRESSED:
                fr[ip + 4 + 8] ^= 0xFF
                break
            ip += 4 + ln
        with pytest.raises(ValueError):
            srv.decompress_framed(bytes(fr)).result(timeout=TIMEOUT)
        assert srv.decompress_framed(framing.STREAM_ID).result(
            timeout=60) == b""
        with pytest.raises(ValueError, match="stream identifier"):
            srv.decompress_framed(b"not framed").result(timeout=60)


def _oversize_framed_chunk(n: int = 65536):
    """A spec-valid compressed chunk whose payload exceeds the device
    fragment capacity: n one-byte literals (about 128 KB)."""
    data = (b"\x5a\xa5" * ((n + 1) // 2))[:n]
    elems = b"".join(b"\x00" + data[i:i + 1] for i in range(n))
    payload = fmt.varint_encode(n) + elems
    body = framing.mask(framing.crc32c(data)).to_bytes(4, "little") + payload
    return (bytes([framing.CHUNK_COMPRESSED])
            + len(body).to_bytes(3, "little") + body), data


def test_framed_oversize_chunk_settles_on_host_not_wave():
    chunk, data = _oversize_framed_chunk()
    assert len(chunk) - 4 - 4 > ops_decode.FRAG_CAP
    fr_bad = framing.STREAM_ID + chunk
    normal = _text(100_000)
    fr_ok = framing.compress(normal, device="cpu")
    with _server(wave=4, max_wait_ms=150) as srv:
        f1 = srv.decompress_framed(fr_bad)
        f2 = srv.decompress_framed(fr_ok)
        assert f1.result(timeout=TIMEOUT) == data
        assert f2.result(timeout=TIMEOUT) == normal
        stats = srv.stats
    assert stats.spliced_fragments >= 1
    assert stats.units == 2  # the oversize chunk never rode a wave
    assert framing.decompress(fr_bad, device="cpu") == data


def test_framed_oversize_uncompressed_chunk_rejected():
    piece = b"x" * 70_000
    body = framing.mask(framing.crc32c(piece)).to_bytes(4, "little") + piece
    fr = (framing.STREAM_ID + bytes([framing.CHUNK_UNCOMPRESSED])
          + len(body).to_bytes(3, "little") + body)
    with pytest.raises(ValueError):
        framing.decompress(fr, device="cpu")
    with _server(wave=4, max_wait_ms=100) as srv:
        with pytest.raises(ValueError):
            srv.decompress_framed(fr).result(timeout=60)


def test_many_threads_submit():
    # More submitting threads than cores, switching often: no request,
    # unit or latency sample may be lost.
    payloads = {i: _rand(65_536 + 137 * i, seed=i) for i in range(16)}
    results = {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with _server(wave=8, max_wait_ms=100) as srv:
            def work(i):
                comp = srv.compress(payloads[i]).result(timeout=TIMEOUT)
                results[i] = srv.decompress(comp).result(timeout=TIMEOUT)
            threads = [threading.Thread(target=work, args=(i,))
                       for i in payloads]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=TIMEOUT)
            assert not any(t.is_alive() for t in threads)
            stats = srv.stats
    finally:
        sys.setswitchinterval(interval)
    assert results == payloads
    assert stats.requests == len(stats.latencies_s) == 32
    assert stats.units == 2 * (1 + 2 * 15)  # one block, then 15 of two


def test_mesh_serving_matches_single_device():
    # Over an 8-shard virtual CPU mesh each dispatch spans the mesh (wave
    # x 8 slots); the streams are the API's.
    mesh = meshlib.make_mesh(8, device="cpu")
    payloads = [_text(65_536 * 2), _rand(65_536 + 5)]
    with _server(wave=1, max_wait_ms=150, mesh=mesh) as srv:
        comps = [f.result(timeout=TIMEOUT)
                 for f in [srv.compress(p) for p in payloads]]
        outs = [f.result(timeout=TIMEOUT)
                for f in [srv.decompress(c) for c in comps]]
        stats = srv.stats
    assert outs == payloads
    for p, c in zip(payloads, comps):
        assert c == api.compress(p, device="cpu", small_fastpath=False)
        assert _unsnappy(c) == p
    assert stats.waves >= 2
    assert stats.wave_slots == 8 * stats.waves


def _framed_mix(srv, data: bytes) -> dict:
    """Raw and framed round trips of `data` through srv, every policy."""
    out = {"raw": srv.compress(data).result(timeout=TIMEOUT)}
    for p in POLICIES:
        out[p] = srv.compress_framed(data, p).result(timeout=TIMEOUT)
    backs = {k: (srv.decompress_framed(v) if k in POLICIES
                 else srv.decompress(v)) for k, v in out.items()}
    out.update({f"{k} back": f.result(timeout=TIMEOUT)
                for k, f in backs.items()})
    return out


def test_four_shard_mesh_equals_one_shard():
    data = block_mix(5 * N - 500)
    with _server(wave=2, max_wait_ms=50) as one:
        want = _framed_mix(one, data)
        kinds = dict(one.stats.waves_by_kind)
    mesh = meshlib.make_mesh(4, device="cpu")
    with _server(wave=1, max_wait_ms=50, mesh=mesh) as four:
        got = _framed_mix(four, data)
        four_kinds = four.stats.waves_by_kind
    assert got == want
    assert all(want[f"{k} back"] == data for k in ("raw",) + POLICIES)
    assert set(four_kinds) == set(kinds) >= {"enc", "dec", "scd"}


def test_request_spanning_multiple_waves():
    data = _text(65_536 * 5 + 1234)
    with _server(wave=4, max_wait_ms=50) as srv:
        comp = srv.compress(data).result(timeout=TIMEOUT)
        back = srv.decompress(comp).result(timeout=TIMEOUT)
        stats = srv.stats
    assert back == data and _unsnappy(comp) == data
    assert stats.waves >= 4  # 2 encode + 2 decode dispatches


def test_latency_stats_and_backpressure():
    data = _text(65_536 * 2)
    with _server(wave=2, max_wait_ms=20, max_pending=4) as srv:
        futs = [srv.compress(data) for _ in range(3)]  # blocks when full
        for f in futs:
            assert _unsnappy(f.result(timeout=TIMEOUT)) == data
        pct = srv.stats.latency_percentiles()
    assert pct["p50"] is not None and pct["p99"] >= pct["p50"] > 0
    assert len(srv.stats.latencies_s) == 3
    assert serving.ServerStats().latency_percentiles()["p95"] is None


def test_close_rejects_new_work():
    srv = _server(wave=2, max_wait_ms=10)
    fut = srv.compress(_text(65_536 * 2))
    srv.close()
    assert _unsnappy(fut.result(timeout=60)) == _text(65_536 * 2)
    with pytest.raises(RuntimeError):
        srv.compress(_text(70_000))
    assert not srv._worker.is_alive()


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_pipeline_depth_variants_roundtrip(depth):
    # Set on a subclass before construction, so the server runs at that
    # depth from its first wave; depth 0 runs as 1 (the max(1, ...) guard).
    class Server(serving.CodecServer):
        PIPELINE_DEPTH = depth

    payloads = [_text(70_000), _rand(66_000, 4), _text(100_000)]
    comps = [api._host_compress(p) for p in payloads]
    with Server(wave=4, max_wait_ms=50, device="cpu") as srv:
        futs = [srv.compress(p) for p in payloads]
        dfuts = [srv.decompress(c) for c in comps]
        for p, f in zip(payloads, futs):
            assert _unsnappy(f.result(timeout=TIMEOUT)) == p
        for p, f in zip(payloads, dfuts):
            assert f.result(timeout=TIMEOUT) == p


@pytest.mark.parametrize("depth", [1, 2])
def test_waves_run_on_depth_workers_at_once(depth):
    """Each wave runs on a worker thread, at most PIPELINE_DEPTH at once:
    four one-block waves, each held 0.3 s, overlap two at a time at
    depth 2 and never at depth 1."""
    class Server(serving.CodecServer):
        PIPELINE_DEPTH = depth

    lock = threading.Lock()
    state = {"now": 0, "most": 0, "threads": set()}
    payloads = [_rand(N, seed) for seed in range(4)]
    with Server(wave=1, max_wait_ms=1000, device="cpu") as srv:
        encode = srv._encode_wave

        def held(units):
            with lock:
                state["now"] += 1
                state["most"] = max(state["most"], state["now"])
                state["threads"].add(threading.current_thread().name)
            time.sleep(0.3)
            with lock:
                state["now"] -= 1
            return encode(units)

        srv._encode_wave = held
        comps = [f.result(timeout=TIMEOUT)
                 for f in [srv.compress(p) for p in payloads]]
    assert comps == [api.compress(p, device="cpu") for p in payloads]
    assert state["most"] == depth
    assert all(t.startswith("tpu-snappy-torch-wave")
               for t in state["threads"])


def test_failed_wave_fails_only_its_requests():
    """The first encode wave raises: the request it carried fails with
    that error, also when its last block rides the next wave beside
    another request, and that other request succeeds."""
    with _server(wave=2, max_wait_ms=200) as srv:
        encode = srv._encode_wave
        calls = []

        def first_fails(units):
            calls.append(len(units))
            if len(calls) == 1:
                raise RuntimeError("injected wave fault")
            return encode(units)

        srv._encode_wave = first_fails
        f_a = srv.compress(_text(2 * N + 100))   # 3 blocks
        f_b = srv.compress(_text(N + 500, 5))    # 2 blocks
        with pytest.raises(RuntimeError, match="injected"):
            f_a.result(timeout=TIMEOUT)
        assert f_b.result(timeout=TIMEOUT) == api.compress(
            _text(N + 500, 5), device="cpu")
        stats = srv.stats
    assert stats.units == 5 and len(calls) >= 2


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.CodecServer()
    assert threading.active_count() == before  # no thread left running
    with _server(wave=1) as srv:
        assert srv.compress(b"abc").result(timeout=60) == \
            api._host_compress(b"abc")


def test_matches_jax_server():
    """One request mix through the JAX server and the port's, both on the
    CPU at wave 2: every future gives the same bytes or the same
    exception type, and both count the same work units, host requests
    and wave kinds."""
    raw = [_text(30_000), block_mix(2 * N - 100, 5), block_mix(5 * N - 500)]
    framed_in = raw[1]  # word text: hints under "auto", root maps "always"

    def run(srv):
        comps = [srv.compress(p) for p in raw]
        frames = {p: srv.compress_framed(framed_in, p) for p in POLICIES}
        comps = [f.result(timeout=TIMEOUT) for f in comps]
        frames = {p: f.result(timeout=TIMEOUT) for p, f in frames.items()}
        backs = [srv.decompress(c) for c in comps + [CORRUPT_STREAM]]
        fbacks = [srv.decompress_framed(fr) for fr in frames.values()]
        res = comps + list(frames.values())
        for f in backs + fbacks:
            try:
                res.append(f.result(timeout=TIMEOUT))
            except ValueError:
                res.append(ValueError)
        return (res, srv.stats.units, srv.stats.host_fastpath,
                sorted(srv.stats.waves_by_kind))

    with _server(wave=2, max_wait_ms=50) as srv:
        port = run(srv)
    with jax_serving.CodecServer(wave=2, max_wait_ms=50) as srv:
        ref = run(srv)
    assert port == ref
    assert port[0][6:9] == raw and port[0][9] is ValueError
    assert port[0][10:] == [framed_in] * 3
    assert port[3] == (["dcd", "dec", "enc", "scd"] if golden.available()
                       else ["dec", "enc", "scd"])


@pytest.mark.gpu
def test_server_on_the_card_matches_api(cuda):
    data = block_mix(5 * N - 500)
    with serving.CodecServer(wave=2, max_wait_ms=20) as srv:
        got = _framed_mix(srv, data)
        kinds = srv.stats.waves_by_kind
    assert got["raw"] == api.compress(data)
    for p in POLICIES:
        assert got[p] == framing.compress(data, sidecar=p)
    assert all(got[f"{k} back"] == data for k in ("raw",) + POLICIES)
    assert set(kinds) == {"enc", "dec", "scd", "dcd"}


@pytest.mark.gpu
def test_server_across_cards_matches_api(cuda):
    """A mesh of every visible card: each shard's kernels launch on its
    own card (parallel/shard.py makes its device current), so the
    server's and shard's streams are the API's on one card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    from tpu_snappy_torch.parallel import shard
    mesh = meshlib.make_mesh()
    data = block_mix(9 * N - 500)
    comp = api.compress(data)
    assert shard.encode_dp(data, mesh) == comp
    assert shard.decode_dp(comp, mesh) == data
    with serving.CodecServer(wave=2, max_wait_ms=20, mesh=mesh) as srv:
        got = _framed_mix(srv, data)
    assert got["raw"] == comp
    for p in POLICIES:
        assert got[p] == framing.compress(data, sidecar=p)
    assert all(got[f"{k} back"] == data for k in ("raw",) + POLICIES)
