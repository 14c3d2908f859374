"""The mixed-piece generator: it repeats by seed, every seed and every
call get the same plans of pieces, and it keeps the tests' make_data mix
(its piece shares, its sizes, its alphabets and its Zipf law of
words)."""

import json
import pathlib

import numpy as np
import pytest

from portbench.generators import mix as traffic

TRAFFIC = json.loads((pathlib.Path(traffic.__file__).parents[1] / "traffic"
                      / "write.json").read_text())
DATA = TRAFFIC["data"]
SIZE = 4 << 20


def test_repeats_by_seed_and_differs_across_seeds():
    a = traffic.pool(DATA, SIZE, 2**31 + 3)
    assert len(a) == SIZE
    assert traffic.pool(DATA, SIZE, 2**31 + 3) == a
    assert traffic.pool(DATA, SIZE, 2**31 + 4) != a


def _plans(data):
    word_bytes = traffic._mean_word_bytes(data)
    return [traffic.plan(data, j, word_bytes) for j in range(data["plans"])]


def test_plans_keep_the_mix():
    plans = _plans(DATA)
    word_bytes = traffic._mean_word_bytes(DATA)
    for kinds, sizes in plans:
        assert sizes.sum() == DATA["segment_bytes"]
    assert len({sizes.tobytes() for _, sizes in plans}) == len(plans)
    kinds = np.concatenate([k for k, _ in plans])
    sizes = np.concatenate([s[:-1] for _, s in plans])
    last = np.cumsum([len(k) for k, _ in plans]) - 1
    whole = np.ones(len(kinds), dtype=bool)
    whole[last] = False
    shares = np.bincount(kinds, minlength=4) / len(kinds)
    for j, name in enumerate(traffic.KINDS):
        assert shares[j] == pytest.approx(DATA["shares"][name], abs=0.01)
        lo, hi = DATA["sizes"][name]
        if name == "words":
            lo, hi = int(lo * word_bytes), int(hi * word_bytes)
        got = sizes[kinds[whole] == j]
        assert lo <= got.min() and got.max() < hi


def test_plans_keep_make_data_byte_shares():
    """The bytes each kind of piece fills over the plans lie near the
    shares make_data's law gives: count share times the mean size."""
    plans = _plans(DATA)
    word_bytes = traffic._mean_word_bytes(DATA)
    kinds = np.concatenate([k for k, _ in plans])
    sizes = np.concatenate([s for _, s in plans])
    got = np.bincount(kinds, weights=sizes, minlength=4) / sizes.sum()
    mean = np.array([np.mean(DATA["sizes"][name])
                     * (word_bytes if name == "words" else 1)
                     for name in traffic.KINDS])
    want = np.array([DATA["shares"][n] for n in traffic.KINDS]) * mean
    want /= want.sum()
    assert np.allclose(got, want, atol=0.02), (got, want)


def test_every_call_holds_every_plan():
    """Slices of `plans` segments that start on a segment get the same
    mix wherever they start: as many high bytes outside runs, and as many
    bytes in runs, whatever the order of their pieces."""
    seg = DATA["segment_bytes"] // 8
    data = dict(DATA, segment_bytes=seg, plans=2)
    buf = np.frombuffer(traffic.pool(data, 5 * seg, 5), dtype=np.uint8)
    same = np.zeros(buf.size, dtype=bool)
    same[1:-1] = (buf[1:-1] == buf[:-2]) & (buf[1:-1] == buf[2:])
    high = (buf >= 127) & ~same
    first = (high[:2 * seg].mean(), same[:2 * seg].mean())
    for s in range(1, 4):
        part = slice(s * seg, (s + 2) * seg)
        assert high[part].mean() == pytest.approx(first[0], abs=0.003)
        assert same[part].mean() == pytest.approx(first[1], abs=0.003)


def test_inputs_are_the_pool_s_slices():
    small = dict(TRAFFIC, pool_bytes=5 << 16, call_bytes=2 << 16,
                 stride_bytes=1 << 16, slices=4)
    got = traffic.inputs(small, 11)
    buf = traffic.pool(DATA, 5 << 16, 11)
    assert got == traffic.slices(buf, 4, 2 << 16, 1 << 16)


def make_data(size: int, seed: int) -> bytes:
    """A copy of tests/torch_edges.py:make_data (the benchmark imports
    nothing of tests/), the mix the generator keeps."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    vocab = [bytes(letters[rng.integers(0, 26, rng.integers(2, 11))])
             for _ in range(5000)]
    target = size - 12345
    pieces, total = [], 0
    while total < target:
        kind = rng.choice(4, p=[0.55, 0.15, 0.15, 0.15])
        if kind == 0:
            words = [vocab[i % len(vocab)]
                     for i in rng.zipf(1.3, rng.integers(200, 3000))]
            for j in np.flatnonzero(rng.random(len(words)) < 0.08):
                words[j] = str(int(rng.integers(0, 1_000_000))).encode()
            piece = b" ".join(words) + b".\n"
        elif kind == 1:
            piece = rng.integers(32, 127, rng.integers(100, 20000),
                                 dtype=np.uint8).tobytes()
        elif kind == 2:
            piece = rng.integers(0, 256, rng.integers(61, 5000),
                                 dtype=np.uint8).tobytes()
        else:
            piece = bytes([int(rng.integers(0, 256))]) * int(
                rng.integers(10, 30000))
        pieces.append(piece)
        total += len(piece)
    return b"".join(pieces)[:target]


def _classes(buf: bytes) -> np.ndarray:
    """Shares of a-z, digits, spaces, bytes of 127 and above, and the
    rest."""
    b = np.frombuffer(buf, dtype=np.uint8)
    lower = (b >= 97) & (b <= 122)
    digit = (b >= 48) & (b <= 57)
    space = b == 32
    high = b >= 127
    rest = ~(lower | digit | space | high)
    return np.array([m.mean() for m in (lower, digit, space, high, rest)])


def test_byte_classes_keep_make_data():
    got = _classes(traffic.pool(DATA, 16 << 20, 9))
    want = _classes(make_data(16 << 20, 9))
    assert np.allclose(got, want, atol=0.04), (got, want)


def test_word_law_is_zipf_mod_vocabulary():
    words = DATA["vocab_words"]
    law = traffic.word_law(DATA, words)
    rng = np.random.default_rng(1)
    got = np.bincount(traffic._draw(law, 1 << 20, rng), minlength=words)
    want = np.bincount(rng.zipf(DATA["zipf_a"], 1 << 20) % words,
                       minlength=words)
    top = np.argsort(-want)[:20]
    assert np.allclose(got[top], want[top], rtol=0.05, atol=300)


def test_word_pieces_are_words_numbers_and_ends():
    vocab = traffic.vocabulary(DATA)
    law = traffic.word_law(DATA, DATA["vocab_words"])
    word_bytes = traffic._mean_word_bytes(DATA)
    pieces = traffic._word_pieces(np.array([1500, 9000]), DATA, vocab, law,
                                  word_bytes, np.random.default_rng(2))
    for piece, size in zip(pieces, (1500, 9000)):
        text = piece.tobytes()
        assert len(text) == size and text.endswith(b".\n")
        words = text[:-2].split(b" ")[:-1]  # the last may be cut
        assert all(w.isalpha() or w.isdigit() for w in words)
        assert all(2 <= len(w) <= 10 for w in words if w.isalpha())


def test_slices():
    buf = bytes(range(256)) * 4
    got = traffic.slices(buf, 3, 512, 256)
    assert got == [buf[0:512], buf[256:768], buf[512:1024]]
    with pytest.raises(ValueError):
        traffic.slices(buf, 4, 512, 256)
