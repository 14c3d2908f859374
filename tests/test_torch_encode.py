"""The port's encoder (tpu_snappy_torch/ops/encode.py) against the JAX one.

At DEFAULT_CONFIG on the CPU the JAX encoder runs the XLA matcher and the
"sort" placement, which the JAX suite proves byte-identical to its TPU
default route. The port runs that TPU-default route on every device (on
the CPU through its kernels' plain versions), and keeps "sort"
selectable; the output and lengths of both, and the intermediate
candidate table (unpacked from the packed form) and (jump, offset), must
be byte-identical. The JAX oracle runs once per module.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_snappy import format as fmt
from tpu_snappy import reference_codec
from tpu_snappy.config import DEFAULT_CONFIG
from tpu_snappy.ops import encode as E

from tpu_snappy_torch.ops import encode as TE
from tpu_snappy_torch.ops.kernels import matcher as KM

from torch_threads import share_cores

share_cores()

N = fmt.BLOCK_SIZE


def _inputs():
    """Phrase text, random bytes, an RLE pattern, far-copy / long-literal
    interleavings (test_pallas.py:496-499), and rows of 0, 1 and 5 bytes."""
    rng = np.random.default_rng(13)
    unit = bytes(rng.integers(0, 256, 300, "u1"))
    datas = [b"The quick brown fox jumps over the lazy dog. " * 1500,
             bytes(rng.integers(0, 256, 20000, "u1")),
             b"ab" * 8000,
             unit + bytes(rng.integers(0, 256, 500, "u1")) + unit
             + bytes(rng.integers(0, 256, 2000, "u1")) + unit,
             b"z" * 70 + unit + b"z" * 70 + unit[:64],
             b"", b"q", b"hello"]
    blocks = np.zeros((len(datas), N), np.uint8)
    lens = np.zeros(len(datas), np.int32)
    for i, d in enumerate(datas):
        lens[i] = min(len(d), N)
        blocks[i, :lens[i]] = np.frombuffer(d[:lens[i]], np.uint8)
    return blocks, lens


@pytest.fixture(scope="module")
def jax_oracle():
    blocks, lens = _inputs()
    b, n = jnp.asarray(blocks), jnp.asarray(lens)
    iota = jnp.arange(N, dtype=jnp.int32)
    k = DEFAULT_CONFIG.candidates

    def cands_one(block, length):
        key = E._window_keys(block, length, iota)
        return E._candidate_offsets(key, length, iota, k, "class",
                                    DEFAULT_CONFIG.probes)

    cands = jax.jit(jax.vmap(cands_one))(b, n)
    jump, off = jax.jit(jax.vmap(
        lambda c, length: E._matcher_xla(c, length, iota,
                                         DEFAULT_CONFIG.lazy)))(cands, n)
    out, out_lens = E.encode_blocks(b, n, DEFAULT_CONFIG)
    dense, total = E.compact_blocks(out, out_lens)
    return {name: np.asarray(v) for name, v in dict(
        cands=cands, jump=jump, off=off, out=out, out_lens=out_lens,
        dense=dense, total=total).items()}


@pytest.fixture(scope="module")
def port():
    blocks, lens = _inputs()
    b, n = torch.from_numpy(blocks), torch.from_numpy(lens)
    key = TE._window_keys(b, n)
    pref, words = TE._candidate_offsets(key, n)
    cands = KM.unpack_table(pref, words, DEFAULT_CONFIG.candidates)
    jump, off = TE._matcher_xla(cands, n)
    out, out_lens = TE.encode_blocks(b, n)
    sort_out, sort_lens = TE.encode_blocks(b, n, placement="sort")
    dense, total = TE.compact_blocks(out, out_lens)
    return dict(cands=cands.numpy(), jump=jump.numpy(), off=off.numpy(),
                out=out.numpy(), out_lens=out_lens.numpy(),
                sort_out=sort_out.numpy(), sort_lens=sort_lens.numpy(),
                dense=dense.numpy(), total=total)


@pytest.mark.parametrize("name", ["cands", "jump", "off"])
def test_matcher_stages_match_jax(jax_oracle, port, name):
    assert port[name].shape == jax_oracle[name].shape
    assert (port[name] == jax_oracle[name]).all()


def test_encode_blocks_matches_jax(jax_oracle, port):
    assert (port["out_lens"] == jax_oracle["out_lens"]).all()
    assert port["out"].shape == jax_oracle["out"].shape
    assert (port["out"] == jax_oracle["out"]).all()


def test_sort_placement_matches_jax(jax_oracle, port):
    """placement="sort" (XLA lanes + 2N sort) stays selectable, same bytes."""
    assert (port["sort_lens"] == jax_oracle["out_lens"]).all()
    assert (port["sort_out"] == jax_oracle["out"]).all()


def test_unknown_placement_raises():
    b = torch.zeros((1, N), dtype=torch.uint8)
    with pytest.raises(ValueError):
        TE.encode_blocks(b, torch.ones(1, dtype=torch.int32),
                         placement="scatter")


def test_compact_blocks_matches_jax(jax_oracle, port):
    assert port["total"] == int(jax_oracle["total"])
    assert (port["dense"] == jax_oracle["dense"]).all()


def test_encoded_rows_decode_to_input(port):
    blocks, lens = _inputs()
    for i, n in enumerate(lens):
        row = port["out"][i, :port["out_lens"][i]].tobytes()
        comp = fmt.varint_encode(int(n)) + row
        assert reference_codec.decompress(comp) == blocks[i, :n].tobytes(), i



@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_encode_blocks_on_the_card_matches_jax(jax_oracle, cuda):
    blocks, lens = _inputs()
    out, out_lens = TE.encode_blocks(torch.from_numpy(blocks).to(cuda),
                                     torch.from_numpy(lens).to(cuda))
    assert (out_lens.cpu().numpy() == jax_oracle["out_lens"]).all()
    assert (out.cpu().numpy() == jax_oracle["out"]).all()
