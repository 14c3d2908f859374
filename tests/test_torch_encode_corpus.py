"""The port's whole-corpus encode (encode_corpus, encode_corpus_compact)
and the API's multi-wave compress against the JAX package.

Five blocks of synthetic data (text, random bytes, a byte run, a short
last block), padded with a zero-length row to three waves of two: the
port's encode_corpus_compact must give JAX encode_corpus_compact's rows,
lengths and dense stream (one JAX compile, the one JAX api.compress makes
at wave 2), encode_corpus must hold each wave's encode_blocks rows and
compact them in order (also across compact_blocks' row chunks), and
api.compress at wave 2 (three waves, one fetch) must give the bytes of
wave 8 (one wave), of the JAX API, and the input under reference_codec.
"""

import numpy as np
import pytest
import torch

from tpu_snappy import api as jax_api
from tpu_snappy import reference_codec
from tpu_snappy.config import DEFAULT_CONFIG as JAX_DEFAULT
from tpu_snappy.ops import encode as JE

from tpu_snappy_torch import api
from tpu_snappy_torch.ops import encode as TE

from torch_threads import share_cores

share_cores()

WAVE = 2


def _five_blocks() -> bytes:
    rng = np.random.default_rng(31)
    text = b"The quick brown fox jumps over the lazy dog. " * 8000
    return (text[:150000] + bytes(rng.integers(0, 256, 60000, "u1"))
            + b"\x07" * 50000 + text[:40000])  # 300000 bytes: 5 blocks


@pytest.fixture(scope="module")
def corpus():
    """(data, padded blocks, padded lengths) as the JAX API makes them,
    and the JAX package's (dense, lens, total) at wave 2."""
    data = _five_blocks()
    blocks, lengths = jax_api._to_blocks(data, JAX_DEFAULT.block_size)
    assert len(lengths) == 5
    blocks = np.pad(blocks, ((0, 1), (0, 0)))
    lengths = np.pad(lengths, (0, 1))
    # Called as tpu_snappy/api.py:104 calls it, so that the API's compress
    # below reuses this compile.
    dense, lens, total = JE.encode_corpus_compact(blocks, lengths,
                                                  JAX_DEFAULT, wave=WAVE)
    return data, blocks, lengths, (np.asarray(dense), np.asarray(lens),
                                   int(total))


@pytest.fixture(scope="module")
def port_corpus(corpus):
    """The port's encode_corpus_compact at wave 2, with each wave's
    encode_blocks result recorded on the way."""
    _, blocks, lengths, _ = corpus
    waves = []
    encode_blocks = TE.encode_blocks

    def recorded(*args, **kwargs):
        waves.append(encode_blocks(*args, **kwargs))
        return waves[-1]

    TE.encode_blocks = recorded
    try:
        res = TE.encode_corpus_compact(torch.from_numpy(blocks),
                                       torch.from_numpy(lengths), wave=WAVE)
    finally:
        TE.encode_blocks = encode_blocks
    return res, waves


def test_encode_corpus_compact_matches_jax(corpus, port_corpus):
    _, _, _, (dense_j, lens_j, total_j) = corpus
    (dense, lens, total), _ = port_corpus
    assert total == total_j
    assert (lens.numpy() == lens_j).all() and lens_j[-1] == 0
    assert dense.shape == dense_j.shape
    assert (dense.numpy() == dense_j).all()


def test_encode_corpus_holds_each_waves_rows(corpus, port_corpus):
    _, blocks, lengths, _ = corpus
    (dense, lens, total), waves = port_corpus
    assert len(waves) == 3
    out = torch.cat([o for o, _ in waves])
    assert torch.equal(lens, torch.cat([n for _, n in waves]))
    d2, t2 = TE.compact_blocks(out, lens)
    assert t2 == total and torch.equal(d2, dense)
    got, got_lens = TE.encode_corpus(torch.from_numpy(blocks[:2]),
                                     torch.from_numpy(lengths[:2]), wave=2)
    assert torch.equal(got, waves[0][0]) and torch.equal(got_lens,
                                                         waves[0][1])


def test_compress_in_waves_gives_the_one_wave_bytes(corpus):
    data = corpus[0]
    comp = api.compress(data, device="cpu", small_fastpath=False, wave=WAVE)
    assert comp == api.compress(data, device="cpu", small_fastpath=False,
                                wave=8)
    assert comp == jax_api.compress(data, small_fastpath=False, wave=WAVE)
    assert reference_codec.decompress(comp) == data


@pytest.mark.parametrize("size, waves", [
    (3 * 65536 + 5, [WAVE]),  # four blocks: two waves of two
    (100, [1]),               # one block: one wave of one, no padding
])
def test_compress_runs_one_corpus_encode(corpus, monkeypatch, size, waves):
    calls = []
    compact = TE.encode_corpus_compact

    def counted(*args, **kwargs):
        calls.append(kwargs.get("wave"))
        return compact(*args, **kwargs)

    monkeypatch.setattr(TE, "encode_corpus_compact", counted)
    data = corpus[0][:size]
    comp = api.compress(data, device="cpu", small_fastpath=False, wave=WAVE)
    assert calls == waves
    assert reference_codec.decompress(comp) == data


@pytest.mark.parametrize("nb", [5, 2 * TE._COMPACT_ROWS + 5])
def test_compact_blocks_joins_the_rows_in_order(nb):
    """Across the row chunks compact_blocks masks at once."""
    rng = np.random.default_rng(nb)
    cap = 40
    lens = rng.integers(0, cap + 1, nb).astype(np.int32)
    out = rng.integers(1, 256, (nb, cap)).astype(np.uint8)
    out[np.arange(cap) >= lens[:, None]] = 0
    dense, total = TE.compact_blocks(torch.from_numpy(out),
                                     torch.from_numpy(lens))
    want = b"".join(out[i, :lens[i]].tobytes() for i in range(nb))
    assert total == len(want) and dense.shape == (nb * cap,)
    assert dense[:total].numpy().tobytes() == want
    assert not dense[total:].any()


@pytest.mark.parametrize("placement", ["auto", "kernel"])
def test_encode_corpus_keeps_the_placements_rows(corpus, placement):
    """Each placement's own row width (kernel: whole rows of 128 cells)."""
    _, blocks, lengths, _ = corpus
    b, n = torch.from_numpy(blocks[4:]), torch.from_numpy(lengths[4:])
    got, got_lens = TE.encode_corpus(b, n, placement=placement, wave=1)
    want, want_lens = TE.encode_blocks(b, n, placement=placement)
    assert got.shape == want.shape
    assert torch.equal(got, want) and torch.equal(got_lens, want_lens)


@pytest.mark.parametrize("nb, wave", [(5, 2), (3, 8), (0, 2)])
def test_encode_corpus_needs_whole_waves(nb, wave):
    blocks = torch.zeros((nb, 65536), dtype=torch.uint8)
    lengths = torch.zeros(nb, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of the wave"):
        TE.encode_corpus(blocks, lengths, wave=wave)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_compress_in_waves_on_the_card(corpus, cuda):
    data = corpus[0]
    assert api.compress(data, device=cuda, small_fastpath=False,
                        wave=WAVE) == api.compress(data, device="cpu",
                                                   small_fastpath=False,
                                                   wave=WAVE)
