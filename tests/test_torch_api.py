"""The port's API (tpu_snappy_torch.api) against the JAX API and the goldens.

api.compress on the CPU must give the JAX api.compress bytes for a
multi-block input and round-trip through the port, reference_codec and
the C++ golden; the wave width and the small-input host path must not
change any byte; and importing the port must not import JAX. The `gpu`
test drives the same round trip on the card.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_snappy import api as jax_api
from tpu_snappy import format as fmt
from tpu_snappy import reference_codec
from tpu_snappy.utils import corpus

from tpu_snappy_torch import api
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
