"""The port's framed compress against the framed cell's plain reference
(portbench/reference_framed.py), on the CPU.

framing.compress(..., "auto") of seeded make_data inputs, whose blocks
take every chunk kind (Zipf text with 0x81 depth hints, a one-byte run
with a 0x80 root map, a random block stored as 0x01, a short last
block), decodes under the reference to its input with every sidecar
holding and none missing; a flipped CRC bit, a flipped root-map byte, a
reserved chunk type and a stripped sidecar are each caught; the cell's control fails the entry's check; the
reference's own framed stream decodes under framing.decompress; the
reference loads nothing of the port or of JAX; and one call records each
of framing's five spans once, nested in framing.compress, with the same
bytes as without tracing.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from portbench import reference_framed as RF
from portbench.entries import framed
from tpu_snappy_torch import framing as TF
from tpu_snappy_torch.config import DEFAULT_CONFIG
from tpu_snappy_torch.utils import profiling

from torch_edges import make_data
from torch_threads import share_cores

share_cores()

N = TF.MAX_CHUNK
ROOT = pathlib.Path(__file__).resolve().parent.parent
STAGES = ("framing.encode", "framing.crc", "framing.sidecar",
          "framing.assemble")
CONTAINER = json.loads((ROOT / "portbench" / "configs"
                        / "framed-default.json").read_text())["container"]


def _input(seed: int) -> bytes:
    """Two blocks of make_data's mix, a random block, a one-byte run, and
    a short last block of the mix."""
    rng = np.random.default_rng(seed)
    mix = make_data(3 * N, seed)
    return (mix[:2 * N] + rng.integers(0, 256, N, dtype=np.uint8).tobytes()
            + bytes([int(rng.integers(0, 256))]) * N + mix[2 * N:2 * N + 9000])


def _check(stream: bytes, data: bytes, container=CONTAINER) -> tuple:
    return RF.check(stream, data, container)


def _kinds(stream: bytes) -> list:
    return [kind for kind, _ in RF.parse(stream)]


@pytest.fixture(scope="module")
def streams():
    return {seed: (_input(seed),
                   TF.compress(_input(seed), sidecar="auto", device="cpu"))
            for seed in (5, 2**32 + 9)}


@pytest.mark.parametrize("seed", [5, 2**32 + 9])
def test_port_stream_holds_under_the_reference(streams, seed):
    data, stream = streams[seed]
    kinds = _kinds(stream)
    assert kinds.count(RF.UNCOMPRESSED) == 1
    assert RF.ROOT_MAP in kinds and RF.DEPTH_HINTS in kinds
    assert sum(k in (RF.COMPRESSED, RF.UNCOMPRESSED) for k in kinds) == 5
    assert _check(stream, data) == (0, 0, 0)


def _flip(stream: bytes, at: int, bit: int = 1) -> bytes:
    out = bytearray(stream)
    out[at] ^= bit
    return bytes(out)


def _offsets(stream: bytes, kind: int) -> list:
    """Body offsets of the chunks of `kind`."""
    out, pos = [], len(RF.STREAM_ID)
    while pos < len(stream):
        if stream[pos] == kind:
            out.append(pos + 4)
        pos += 4 + int.from_bytes(stream[pos + 1:pos + 4], "little")
    return out


def test_flipped_crc_bit_is_caught(streams):
    data, stream = streams[5]
    at = _offsets(stream, RF.COMPRESSED)[0]
    assert _check(_flip(stream, at + 2, 0x10), data) == (N, 0, 0)


def test_flipped_root_map_byte_is_caught(streams):
    data, stream = streams[5]
    at = _offsets(stream, RF.ROOT_MAP)[0]
    count = int.from_bytes(stream[at + 4:at + 8], "little")
    # The first root: the element byte every output byte of piece 0 reads.
    assert _check(_flip(stream, at + 8 + 2 * count), data) == (0, 1, 0)


def test_reserved_chunk_type_is_caught(streams):
    data, stream = streams[5]
    cut = len(RF.STREAM_ID)
    skippable = stream[:cut] + b"\x90\x02\x00\x00ab" + stream[cut:]
    assert _check(skippable, data) == (0, 0, 0)
    reserved = stream[:cut] + b"\x02\x02\x00\x00ab" + stream[cut:]
    assert _check(reserved, data) == (len(data), 0, 0)


def _strip(stream: bytes, count: int) -> bytes:
    """The stream without its first `count` 0x80 and 0x81 chunks."""
    out, pos = [stream[:len(RF.STREAM_ID)]], len(RF.STREAM_ID)
    while pos < len(stream):
        end = pos + 4 + int.from_bytes(stream[pos + 1:pos + 4], "little")
        if stream[pos] in (RF.ROOT_MAP, RF.DEPTH_HINTS) and count:
            count -= 1
        else:
            out.append(stream[pos:end])
        pos = end
    return b"".join(out)


def test_stripped_sidecar_is_caught(streams):
    """"auto" promises a sidecar before each of the four compressed
    chunks (the shortest holds 9000 bytes, over the floor); a stream
    without them is policy "off"'s, under which none is missing."""
    data, stream = streams[5]
    assert RF.sidecar_floor(CONTAINER) == 2667
    assert _check(_strip(stream, 1), data) == (0, 0, 1)
    bare = _strip(stream, len(stream))
    assert _check(bare, data) == (0, 0, 4)
    assert _check(bare, data, dict(CONTAINER, sidecar="off")) == (0, 0, 0)


def test_control_fails_the_entry_check(streams):
    inputs = [_input(7)[:2 * N + 100], _input(8)[:N]]
    entry = framed.Entry(DEFAULT_CONFIG, inputs, "cpu")
    got = entry.check([(k, entry.control(k)) for k in range(len(inputs))])
    assert got["mismatched_bytes"][0] == sum(map(len, inputs))
    sound = framed.Entry(DEFAULT_CONFIG, [streams[s][0] for s in streams],
                         "cpu")
    assert sound.check([(k, streams[s][1]) for k, s in enumerate(streams)]
                       ) == {"mismatched_bytes": (0, 0, "<="),
                             "bad_sidecars": (0, 0, "<="),
                             "missing_sidecars": (0, 0, "<=")}


def test_reference_stream_decodes_under_the_port(streams):
    data, _ = streams[2**32 + 9]
    stream = RF.compress(data)
    assert set(_kinds(stream)) == {RF.COMPRESSED, RF.UNCOMPRESSED}
    assert TF.decompress(stream, device="cpu") == data


def test_reference_loads_nothing_of_the_port_or_jax():
    code = ("import json, sys; import portbench.reference_framed; "
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "portbench" in tops
    assert not tops & {"jax", "jaxlib", "tpu_snappy", "tpu_snappy_torch"}


def test_one_call_records_each_framing_span_once(streams):
    data, stream = streams[5]
    with profiling.tracing(ranges=False) as rec:
        traced = TF.compress(data, sidecar="auto", device="cpu")
    assert traced == stream
    mine = [s for s in rec.spans if s.name.startswith("framing.")]
    names = [s.name for s in mine]
    assert sorted(names) == sorted(("framing.compress",) + STAGES)
    outer = next(s for s in mine if s.name == "framing.compress")
    assert outer.parent == -1
    for s in mine:
        if s.name != "framing.compress":
            assert s.parent == outer.index and s.call == outer.call
            assert outer.t0 <= s.t0 <= s.t1 <= outer.t1
