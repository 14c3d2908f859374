"""The port's encoder at the other CodecConfig knobs against the JAX encoder.

Stride 4 (strided keys, u32 words), probes > candidates (the ladder
dedup), flatten "full", "lift" (three more forward fills) and "off" (the
unpacked table and `matcher_block`), table "intervals" (the interval-
aware sticky scan, candidates=12 and probes=14 as in tests/test_fuzz.py)
and a block size below 64 KB. On the rows of test_torch_presets.py the
port's encode_blocks must equal tpu_snappy.ops.encode.encode_blocks byte
for byte, api.compress must equal the JAX api.compress on a two-block
input and round-trip, and the JAX package's trace-time asserts must be
ValueErrors here. Candidate counts above 16 (K 17 and 18, sticky "exact"
and "sig", which kernel instances of their own take on the card, and K
26, which the wide matcher kernel takes) give the JAX api.compress bytes.
The `gpu` tests repeat the encode on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_snappy import api as jax_api
from tpu_snappy import config as JC
from tpu_snappy import reference_codec
from tpu_snappy.ops import encode as E

from tpu_snappy_torch import api
from tpu_snappy_torch import config as TC
from tpu_snappy_torch.ops import encode as TE
from tpu_snappy_torch.ops.kernels import matcher as KM

from test_torch_presets import data_70k, rows

from torch_threads import share_cores

share_cores()

N = 1 << 16
KNOBS = {"stride4": dict(stride=4),
         "probes": dict(candidates=8, probes=12),
         "full": dict(flatten="full"),
         "lift": dict(flatten="lift"),
         "off": dict(flatten="off"),
         "intervals": dict(candidates=12, probes=14, table="intervals")}


def _cfgs(knobs: dict):
    return (dataclasses.replace(JC.DEFAULT_CONFIG, **knobs),
            dataclasses.replace(TC.DEFAULT_CONFIG, **knobs))


@pytest.mark.parametrize("knob", KNOBS)
def test_encode_blocks_matches_jax(knob):
    jcfg, tcfg = _cfgs(KNOBS[knob])
    blocks, lens = rows()
    want, want_lens = E.encode_blocks(jnp.asarray(blocks), jnp.asarray(lens),
                                      jcfg)
    out, out_lens = TE.encode_blocks(torch.from_numpy(blocks),
                                     torch.from_numpy(lens), tcfg)
    assert (out_lens.numpy() == np.asarray(want_lens)).all()
    assert (out.numpy() == np.asarray(want)).all()


API_KNOBS = dict(KNOBS, block_size=dict(block_size=20000))


@pytest.mark.parametrize("knob", API_KNOBS)
def test_api_compress_matches_jax_and_round_trips(knob):
    jcfg, tcfg = _cfgs(API_KNOBS[knob])
    data = data_70k()
    comp = api.compress(data, tcfg, device="cpu")
    assert comp == jax_api.compress(data, jcfg)
    assert api.decompress(comp, tcfg, device="cpu") == data
    assert reference_codec.decompress(comp) == data


def test_short_blocks_cut_at_block_size():
    """block_size=20000 cuts 70 KB into 4 blocks of at most 20000 bytes,
    each in its own 64 KB row."""
    blocks, lens = api._to_blocks(data_70k(), 20000)
    assert blocks.shape == (4, N) and lens.tolist() == [20000] * 3 + [10000]
    assert not blocks[:, 20000:].any()
    assert b"".join(blocks[i, :n].tobytes()
                    for i, n in enumerate(lens)) == data_70k()


@pytest.mark.parametrize("stride", [2, 4])
def test_strided_keys_match_jax_and_the_full_keys(stride):
    blocks, lens = rows()
    b, n = torch.from_numpy(blocks), torch.from_numpy(lens)
    got = TE._window_keys_strided(b, n, stride)
    assert torch.equal(got, TE._window_keys(b, n)[:, ::stride])
    for i in range(len(lens)):
        want = E._window_keys_strided(jnp.asarray(blocks[i]),
                                      jnp.int32(lens[i]), stride)
        assert (got[i].numpy() == np.asarray(want)).all()


def test_the_jax_asserts_are_value_errors():
    blocks, lens = rows()
    b, n = torch.from_numpy(blocks[:1]), torch.from_numpy(lens[:1])
    key = TE._window_keys(b, n)
    odd_off = dataclasses.replace(TC.DEFAULT_CONFIG, candidates=5,
                                  flatten="off")
    with pytest.raises(ValueError, match="flattening slot"):
        TE._candidate_offsets(key, n, odd_off, packed=False)
    off = dataclasses.replace(TC.DEFAULT_CONFIG, flatten="off")
    with pytest.raises(ValueError, match="flattening slot"):
        TE._candidate_offsets(key, n, off)


#: Candidate counts above 16, with the JAX package's stream sizes on _fox:
#: each runs the packed matcher wrapper (on the CPU its plain version, on
#: the card K 17 and 18 their own kernel instances and K 26, past
#: matcher.FIXED_K, the wide kernel).
WIDE_K = {"k18": (dict(candidates=18, probes=18), 9101),
          "k17": (dict(candidates=17, probes=17), 9101),
          "k18_sig": (dict(candidates=18, probes=18, sticky="sig"), 9758),
          "k26": (dict(candidates=26, probes=26), 7845)}


def _fox() -> bytes:
    return b"".join(b"the quick brown fox jumps over the lazy dog %d " % i
                    for i in range(3000))[:70000]


@pytest.mark.parametrize("knob", WIDE_K)
def test_wide_k_encodes_as_jax(knob):
    """K 17, 18 ("exact" and "sig") and 26 give the JAX package's
    bytes."""
    knobs, size = WIDE_K[knob]
    jcfg, tcfg = _cfgs(knobs)
    assert tcfg.candidates > 16
    data = _fox()
    comp = api.compress(data, tcfg, device="cpu", small_fastpath=False)
    assert len(comp) == size
    assert comp == jax_api.compress(data, jcfg, small_fastpath=False)
    assert reference_codec.decompress(comp) == data


def test_flatten_off_feeds_the_unpacked_matcher(monkeypatch):
    """flatten "off" runs matcher_block on the (B, N, K) table (and no
    packed matcher); the points presets run the packed one."""
    seen = []
    for name in ("matcher_block", "matcher_block_packed"):
        real = getattr(KM, name)
        monkeypatch.setattr(KM, name, lambda *a, _n=name, _r=real, **k: (
            seen.append(_n), _r(*a, **k))[1])
    blocks, lens = rows()
    b, n = torch.from_numpy(blocks[:2]), torch.from_numpy(lens[:2])
    TE.encode_blocks(b, n, _cfgs(KNOBS["off"])[1])
    TE.encode_blocks(b, n, TC.TURBO_CONFIG)
    assert seen == ["matcher_block", "matcher_block_packed"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("knob", KNOBS)
def test_knobs_on_the_card_match_the_cpu(knob, cuda):
    tcfg = _cfgs(KNOBS[knob])[1]
    blocks, lens = rows()
    b, n = torch.from_numpy(blocks), torch.from_numpy(lens)
    want, want_lens = TE.encode_blocks(b, n, tcfg)
    out, out_lens = TE.encode_blocks(b.to(cuda), n.to(cuda), tcfg)
    assert torch.equal(out_lens.cpu(), want_lens)
    assert torch.equal(out.cpu(), want)


@pytest.mark.gpu
def test_wide_k_on_the_card_matches_the_cpu(cuda):
    """The matcher kernels at K 17, 18 and (the wide kernel, past
    FIXED_K) 26 against the CPU's plain matcher: the same bytes."""
    data = _fox()
    for knob in WIDE_K:
        tcfg = _cfgs(WIDE_K[knob][0])[1]
        assert (api.compress(data, tcfg, device=cuda, small_fastpath=False)
                == api.compress(data, tcfg, device="cpu",
                                small_fastpath=False)), knob
    assert _cfgs(WIDE_K["k26"][0])[1].candidates > KM.FIXED_K
