"""The port's API (tpu_snappy_torch.api) against the JAX API and the goldens.

api.compress on the CPU must give the JAX api.compress bytes for a
multi-block input and round-trip through the port, reference_codec and
the C++ golden; the wave width and the small-input host path must not
change any byte; and importing the port must not import JAX. compress
stages its input on the device from the caller's bytes (bytes, bytearray
or memoryview), neither writing them nor warning, and without the host
block array framing.compress still builds. The `gpu` tests drive the
same round trip on the card, and two waves with a partial last block.
"""

import dataclasses
import functools
import hashlib
import pathlib
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from tpu_snappy import api as jax_api
from tpu_snappy import config as JC
from tpu_snappy import format as fmt
from tpu_snappy import framing as jax_framing
from tpu_snappy import reference_codec
from tpu_snappy.utils import corpus

from tpu_snappy_torch import api
from tpu_snappy_torch import config as TC
from tpu_snappy_torch import framing
from tpu_snappy_torch.ops import decode as TD

from torch_threads import share_cores

share_cores()


def _three_blocks() -> bytes:
    rng = np.random.default_rng(21)
    text = b"The quick brown fox jumps over the lazy dog. " * 1600
    return (text[:60000] + bytes(rng.integers(0, 256, 9000, "u1"))
            + corpus.synth("random", 40000) + b"\x00" * 30000
            + text[:10000])  # 149000 bytes: two full blocks and a partial


@pytest.fixture(scope="module")
def streams():
    data = _three_blocks()
    return data, api.compress(data, device="cpu", small_fastpath=False)


def test_compress_matches_jax_api(streams):
    data, comp = streams
    assert comp == jax_api.compress(data, small_fastpath=False)


def test_round_trip_through_port_and_goldens(streams):
    data, comp = streams
    got, stats = api.decompress_with_stats(comp, device="cpu",
                                           small_fastpath=False)
    assert got == data
    assert stats.path == "device" and stats.fragments == 3
    assert stats.spliced == 0
    assert reference_codec.decompress(comp) == data
    golden = TD.native_golden()
    if golden is not None:
        assert golden.uncompress(comp) == data


def test_wave_width_changes_no_byte(streams):
    data, comp = streams
    assert api.compress(data, device="cpu", small_fastpath=False,
                        wave=2) == comp
    assert api.decompress(comp, device="cpu", small_fastpath=False,
                          wave=2) == data


def test_small_inputs_take_the_host_codec():
    data = b"hello hello hello hello snappy " * 100
    comp = api.compress(data, device="cpu")
    assert comp == jax_api._host_compress(data)
    got, stats = api.decompress_with_stats(comp, device="cpu")
    assert got == data and stats.path == "host-small"
    assert api.decompress(fmt.varint_encode(0), device="cpu") == b""


def test_import_pulls_in_no_jax():
    code = ("import sys\n"
            "import tpu_snappy_torch, tpu_snappy_torch.api\n"
            "import tpu_snappy_torch.ops.encode, tpu_snappy_torch.ops.decode\n"
            "from tpu_snappy_torch.ops.kernels import (_build, ffill, scatter,"
            " tiledres, windows)\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=pathlib.Path(__file__).resolve().parent.parent)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def _mixed(n: int) -> bytes:
    """`n` bytes of text, random bytes and a run, in 40000-byte turns."""
    rng = np.random.default_rng(n)
    text = b"The quick brown fox jumps over the lazy dog. " * 900
    turn = (text[:40000] + bytes(rng.integers(0, 256, 40000, "u1"))
            + b"\x07" * 40000)
    return (turn * (n // len(turn) + 1))[:n]


#: Staging cases: (bytes, config knobs, small_fastpath, wave). Sub-block
#: inputs take the device path at TURBO_CONFIG, and at DEFAULT_CONFIG
#: without the host fast path; "wave2" pads three blocks (the last of one
#: byte) to two waves of two rows; "bs20000" cuts blocks short of a row.
STAGING = {"empty-turbo": (0, "turbo", True, None),
           "one-turbo": (1, "turbo", True, None),
           "sub-block-turbo": (65535, "turbo", True, None),
           "empty-default": (0, "default", False, None),
           "one-default": (1, "default", False, None),
           "sub-block-default": (65535, "default", False, None),
           "one-block": (65536, "default", True, None),
           "three-blocks": (2 * 65536 + 1, "default", True, None),
           "wave2": (2 * 65536 + 1, "default", True, 2),
           "bs20000": (45001, "bs20000", True, None)}

BUFFERS = {"bytes": bytes, "bytearray": bytearray, "memoryview":
           lambda b: memoryview(bytearray(b))}


def _cfgs(name: str):
    """(JAX config, port config) of a staging case."""
    if name == "turbo":
        return JC.TURBO_CONFIG, TC.TURBO_CONFIG
    if name == "bs20000":
        return (dataclasses.replace(JC.DEFAULT_CONFIG, block_size=20000),
                dataclasses.replace(TC.DEFAULT_CONFIG, block_size=20000))
    return JC.DEFAULT_CONFIG, TC.DEFAULT_CONFIG


@functools.lru_cache(maxsize=None)
def _jax_stream(case: str) -> bytes:
    """The JAX API's stream of a staging case (at its own wave: the wave
    changes no byte)."""
    n, cfg, fastpath, _ = STAGING[case]
    return jax_api.compress(_mixed(n), _cfgs(cfg)[0],
                            small_fastpath=fastpath)


@pytest.mark.parametrize("kind", BUFFERS)
@pytest.mark.parametrize("case", STAGING)
def test_staging_matches_jax_api(case, kind):
    n, cfg, fastpath, wave = STAGING[case]
    data = BUFFERS[kind](_mixed(n))
    got = api.compress(data, _cfgs(cfg)[1], device="cpu",
                       small_fastpath=fastpath, wave=wave)
    assert got == _jax_stream(case)


def test_compress_leaves_the_callers_buffer():
    data = bytearray(_mixed(2 * 65536 + 1))
    before = hashlib.sha256(data).hexdigest()
    api.compress(data, device="cpu")
    api.compress(memoryview(data), TC.TURBO_CONFIG, device="cpu")
    assert hashlib.sha256(data).hexdigest() == before


def test_compress_emits_no_user_warning():
    """A fresh process compresses bytes twice with warnings as errors:
    torch's one warning on a tensor over a read-only buffer is kept from
    the caller, at the first call and at the second."""
    code = ("import warnings\n"
            "from tpu_snappy_torch import api\n"
            "with warnings.catch_warnings():\n"
            "    warnings.simplefilter('error')\n"
            "    for _ in range(2):\n"
            "        api.compress(bytes(70000), device='cpu')\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=pathlib.Path(__file__).resolve().parent.parent)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
    api.compress(bytes(70000), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        api.compress(bytes(70000), device="cpu")


def _refuse(*args, **kwargs):
    raise AssertionError("api.compress made a host copy of its input")


def test_compress_makes_no_host_block_array(streams, monkeypatch):
    data, comp = streams
    monkeypatch.setattr(api, "_to_blocks", _refuse)
    monkeypatch.setattr(np, "pad", _refuse)
    assert api.compress(data, device="cpu", small_fastpath=False) == comp


def test_framing_still_blocks_on_the_host(monkeypatch):
    data = _mixed(2 * 65536 + 1)
    calls = []
    to_blocks = api._to_blocks

    def spy(*args, **kwargs):
        calls.append(args)
        return to_blocks(*args, **kwargs)

    monkeypatch.setattr(api, "_to_blocks", spy)
    assert framing.compress(data, device="cpu") == jax_framing.compress(data)
    assert len(calls) == 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_round_trip_on_the_card(streams, cuda):
    data, comp = streams
    assert api.compress(data, device=cuda, small_fastpath=False) == comp
    got, stats = api.decompress_with_stats(comp, device=cuda,
                                           small_fastpath=False)
    assert got == data and stats.spliced == 0


@pytest.mark.gpu
@pytest.mark.parametrize("preset", ["default", "turbo"])
def test_two_waves_with_a_partial_block_on_the_card(preset, cuda):
    """9 MiB + 123 bytes: 145 blocks, a whole wave of 128 and a partial
    one of 17 rows padded to 128, its last block 123 bytes."""
    cfg = _cfgs(preset)[1]
    data = _mixed(9 * 2**20 + 123)
    assert (api.compress(data, cfg, device=cuda)
            == api.compress(data, cfg, device="cpu"))
