"""The mixed-piece generator (traffic files with `"generator": "mix"`).

`inputs(traffic, seed)` gives a run's inputs: `slices` slices of
`call_bytes`, slice k at k * `stride_bytes`, of a pool of `pool_bytes`
made by `pool(data, nbytes, seed)`. The pool's mix is the seeded one the
port's chip figures were taken on (the tests' `make_data`): pieces of
Zipf-drawn word text with numbers, printable random ASCII,
incompressible random bytes and one-byte runs, at the traffic file's
shares and length ranges. It is built with array operations rather than
piece by piece, and so that every seed, and every call, does the same
work: the pool is made of segments of `segment_bytes`; segment s holds
plan s mod `plans` (a plan: the kinds and sizes in bytes of a segment's
pieces, drawn from the file's `plan_seed` and its index, as make_data
draws them; the vocabulary from `vocab_seed`), and `--seed` draws each
segment's order of pieces and their content (which words, numbers,
bytes and run values). A slice that starts on a segment and spans
`plans` whole segments holds every plan once.
"""

from __future__ import annotations

import numpy as np

KINDS = ("words", "printable", "random", "run")

#: Word pieces whose bytes are built in one set of array operations.
_WORD_CHUNK = 1024


#: Widest token: a word of up to 10 letters or a number of up to 11
#: digits, and its space.
_WIDTH = 12


def vocabulary(data: dict) -> tuple[np.ndarray, np.ndarray]:
    """The file's vocabulary as a (words, _WIDTH) table of a-z rows, each
    followed by a space, and each row's length with the space: `words`
    words of lengths drawn from [lo, hi)."""
    lo, hi = data["word_letters"]
    rng = np.random.default_rng(data["vocab_seed"])
    lengths = rng.integers(lo, hi, data["vocab_words"])
    table = np.zeros((len(lengths), _WIDTH), dtype=np.uint8)
    cols = np.arange(_WIDTH)
    table[:] = rng.integers(0, 26, table.shape) + ord("a")
    table[cols >= lengths[:, None]] = 0
    table[np.arange(len(lengths)), lengths] = ord(" ")
    return table, lengths + 1


def word_law(data: dict, words: int) -> tuple[np.ndarray, np.ndarray]:
    """The law of the vocabulary index i mod `words` for i drawn by the
    Zipf law P(i) ~ i^-a, i >= 1 (numpy's `zipf`), as Walker's alias
    table (the share each slot keeps, and the index it gives the rest
    to): the first 2^22 terms summed exactly, the rest, which varies by
    under 0.2% across `words` consecutive i, shared evenly."""
    a = data["zipf_a"]
    i = np.arange(1, 1 << 22, dtype=np.float64)
    pmf = np.bincount(np.arange(1, 1 << 22) % words, weights=i ** -a,
                      minlength=words)
    pmf += float(1 << 22) ** (1 - a) / (a - 1) / words
    scaled = (pmf * words / pmf.sum()).tolist()
    keep, alias = [1.0] * words, list(range(words))
    small = [j for j, p in enumerate(scaled) if p < 1.0]
    large = [j for j, p in enumerate(scaled) if p >= 1.0]
    while small and large:
        s, g = small.pop(), large[-1]
        keep[s], alias[s] = scaled[s], g
        scaled[g] -= 1.0 - scaled[s]
        if scaled[g] < 1.0:
            small.append(large.pop())
    return np.array(keep), np.array(alias)


def _draw(law, n: int, rng) -> np.ndarray:
    """`n` indices drawn by an alias table."""
    keep, alias = law
    slot = rng.integers(0, len(keep), n)
    return np.where(rng.random(n) < keep[slot], slot, alias[slot])


def plan(data: dict, index: int = 0, word_bytes: float | None = None
         ) -> tuple[np.ndarray, np.ndarray]:
    """(kinds, sizes) of plan `index`, one segment's pieces: indices into
    KINDS drawn at the file's shares, and each piece's size in bytes drawn
    from its kind's range (a word piece's from its range of words, at the
    mix's mean bytes a word), from `plan_seed` and `index`; the last piece
    is cut so that the sizes add up to `segment_bytes`. `word_bytes`: the
    mix's mean bytes a word, where the caller has it."""
    rng = np.random.default_rng([data["plan_seed"], index])
    shares = np.array([data["shares"][k] for k in KINDS], dtype=np.float64)
    lo = np.array([data["sizes"][name][0] for name in KINDS])
    hi = np.array([data["sizes"][name][1] for name in KINDS])
    scale = np.array([word_bytes or _mean_word_bytes(data), 1, 1, 1])
    kinds, sizes, total = [], [], 0
    while total < data["segment_bytes"]:
        k = int(rng.choice(len(KINDS), p=shares / shares.sum()))
        size = int(rng.integers(lo[k], hi[k]) * scale[k])
        kinds.append(k)
        sizes.append(size)
        total += size
    sizes[-1] -= total - data["segment_bytes"]
    return np.array(kinds), np.array(sizes, dtype=np.int64)


def _mean_word_bytes(data: dict, vocab=None, law=None) -> float:
    """Bytes a word takes on average, its separator included."""
    _, lengths = vocab or vocabulary(data)
    keep, alias = law or word_law(data, len(lengths))
    law = keep + np.bincount(alias, weights=1.0 - keep, minlength=len(keep))
    law /= law.sum()
    below = data["number_below"]
    digits = sum(d * (min(below, 10 ** d) - (10 ** (d - 1) if d > 1 else 0))
                 for d in range(1, len(str(below)) + 1)) / below
    share = data["number_share"]
    return float((1 - share) * (law * lengths).sum() + share * (digits + 1))


def _word_pieces(sizes: np.ndarray, data: dict, vocab, law,
                 word_bytes: float, rng) -> list:
    """Word pieces of `sizes` bytes each: words drawn by the Zipf law over
    the vocabulary (`word_law`, `_draw`), a share of them replaced by
    decimal numbers below `number_below`, joined by spaces, each piece cut
    to its size less 2 and ended by ".\n"."""
    table, lengths = vocab
    # Words enough for each piece: 20% over its mean, some 6 standard
    # deviations of a sum of 200 or more words' lengths.
    counts = (sizes / word_bytes * 1.2).astype(np.int64) + 16
    total = int(counts.sum())
    idx = _draw(law, total, rng)
    tok = table[idx]
    tlen = lengths[idx]
    is_num = rng.random(total) < data["number_share"]
    nums = rng.integers(0, data["number_below"], int(is_num.sum()))
    ndig = np.searchsorted(10 ** np.arange(1, _WIDTH - 1), nums,
                           side="right") + 1
    cols = np.arange(_WIDTH)
    place = ndig[:, None] - 1 - cols
    digit = (nums[:, None] // 10 ** np.maximum(place, 0)) % 10 + ord("0")
    row = np.where(place >= 0, digit, 0).astype(np.uint8)
    row[np.arange(len(nums)), ndig] = ord(" ")
    tok[is_num] = row
    tlen[is_num] = ndig + 1
    text = tok[cols < tlen[:, None]]
    starts = np.concatenate([[0], np.cumsum(tlen)[np.cumsum(counts)[:-1]
                                                  - 1]])
    ends = np.cumsum(tlen)[np.cumsum(counts) - 1]
    if (ends - starts < sizes).any():
        raise ValueError("a word piece drew too few words")
    end = np.frombuffer(b".\n", dtype=np.uint8)
    return [np.concatenate([text[s:s + n - 2], end])
            for s, n in zip(starts.tolist(), sizes.tolist())]


def pool(data: dict, nbytes: int, seed: int) -> bytes:
    """`nbytes` bytes of the mix for `seed`: segment s holds the pieces of
    plan s mod `plans`, in an order drawn from the seed, with content
    drawn from it; the last segment cut."""
    vocab = vocabulary(data)
    law = word_law(data, len(vocab[1]))
    word_bytes = _mean_word_bytes(data, vocab, law)
    plans = [plan(data, j, word_bytes) for j in range(data["plans"])]
    segments = -(-nbytes // data["segment_bytes"])
    kinds = np.concatenate([plans[s % len(plans)][0]
                            for s in range(segments)])
    sizes = np.concatenate([plans[s % len(plans)][1]
                            for s in range(segments)])
    bounds = np.cumsum([0] + [len(plans[s % len(plans)][0])
                              for s in range(segments)])
    rng = np.random.default_rng(seed)
    pieces = [None] * len(kinds)
    words = np.flatnonzero(kinds == 0)
    for s in range(0, len(words), _WORD_CHUNK):
        at = words[s:s + _WORD_CHUNK]
        for i, piece in zip(at, _word_pieces(sizes[at], data, vocab, law,
                                             word_bytes, rng)):
            pieces[i] = piece
    for kind, (lo, hi) in ((1, (32, 127)), (2, (0, 256))):
        at = np.flatnonzero(kinds == kind)
        flat = rng.integers(lo, hi, int(sizes[at].sum()), dtype=np.uint8)
        for i, piece in zip(at, np.split(flat, np.cumsum(sizes[at])[:-1])):
            pieces[i] = piece
    at = np.flatnonzero(kinds == 3)
    values = rng.integers(0, 256, len(at), dtype=np.uint8)
    flat = np.repeat(values, sizes[at])
    for i, piece in zip(at, np.split(flat, np.cumsum(sizes[at])[:-1])):
        pieces[i] = piece
    order = np.concatenate([rng.permutation(b - a) + a
                            for a, b in zip(bounds[:-1], bounds[1:])])
    return np.concatenate([pieces[i] for i in order])[:nbytes].tobytes()


def inputs(traffic: dict, seed: int) -> list:
    """The run's inputs for `seed`: the pool's slices."""
    buf = pool(traffic["data"], traffic["pool_bytes"], seed)
    return slices(buf, traffic["slices"], traffic["call_bytes"],
                  traffic["stride_bytes"])


def slices(buf: bytes, count: int, size: int, stride: int) -> list:
    """`count` inputs of `size` bytes, input k starting at k * stride."""
    if (count - 1) * stride + size > len(buf):
        raise ValueError("the pool is too small for its slices")
    return [buf[k * stride:k * stride + size] for k in range(count)]
