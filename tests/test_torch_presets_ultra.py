"""The port's encoder at the JAX package's ULTRA preset (TURBO at stride 2)
against the JAX encoder: encode_blocks of tests/test_torch_presets.py's
rows at every placement, the packed candidate form expanded at stride 2,
api.compress of its 70 KB input and that stream's round trip through the
port and the host codecs, and the framed stream with sidecar "auto",
which must equal the JAX framed stream. The `gpu` test repeats the encode
on the card.
"""

import pytest
import torch

from test_torch_presets import (PRESETS, api_streams,
                                check_api_round_trip, check_encode_blocks,
                                check_odd_k_packed_form, data_70k,
                                jax_encode)

from tpu_snappy import framing as jax_framing

from tpu_snappy_torch import framing
from tpu_snappy_torch.ops import encode as TE

from torch_threads import share_cores

share_cores()

PRESET = "ultra"


@pytest.fixture(scope="module")
def jax_out():
    return jax_encode(PRESET)


@pytest.fixture(scope="module")
def streams():
    return api_streams(PRESET)


@pytest.mark.parametrize("placement", TE.PLACEMENTS)
def test_encode_blocks_matches_jax(jax_out, placement):
    check_encode_blocks(jax_out, PRESET, placement)


def test_api_compress_matches_jax(streams):
    port, want = streams
    assert port == want


def test_api_round_trip(streams):
    check_api_round_trip(PRESET, streams[0])


def test_odd_k_packed_form_matches_jax():
    check_odd_k_packed_form(PRESET)


def test_framed_ultra_auto_matches_jax():
    data = data_70k()
    jcfg, tcfg = PRESETS[PRESET]
    fr = framing.compress(data, tcfg, sidecar="auto", device="cpu")
    assert fr == jax_framing.compress(data, jcfg, sidecar="auto")
    assert framing.decompress(fr, device="cpu", cfg=tcfg) == data
    assert framing.decompress(fr, use_sidecar=False, device="cpu") == data
    assert jax_framing.decompress(fr, jcfg) == data


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_presets_on_the_card_match_jax(jax_out, cuda):
    for placement in TE.PLACEMENTS:
        check_encode_blocks(jax_out, PRESET, placement, cuda)
