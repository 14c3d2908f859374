"""Benchmark corpus access and synthesis (the port's copy of
tpu_snappy/utils/corpus.py).

Plays the role of the reference's DataGenerator.scala (corpus synthesis:
random/real/repeating at 12 sizes, seeded random files) plus the loose corpus
files under data/ and benchmark/benchmark-data/. The reference corpus is
read from the directory that TPU_SNAPPY_REFERENCE names (default:
`reference/` at the root of the checkout); `synth` regenerates equivalent
data when it is not there.
"""

from __future__ import annotations

import os
import pathlib


REFERENCE_ROOT = pathlib.Path(os.environ.get(
    "TPU_SNAPPY_REFERENCE",
    pathlib.Path(__file__).resolve().parents[2] / "reference"))
BENCH_DATA = REFERENCE_ROOT / "benchmark" / "benchmark-data"
DATA = REFERENCE_ROOT / "data"

#: The 12 sizes × 3 types of DataGenerator.scala:24-72.
SIZES = [10, 20, 50, 100, 200, 500, 1000, 2000, 5000, 10000, 20000, 50000]
TYPES = ["random", "real", "repeating"]


def has_reference_corpus() -> bool:
    return BENCH_DATA.is_dir() and DATA.is_dir()


def load(name: str) -> bytes:
    """Load a corpus file by bare name from either corpus directory."""
    for root in (BENCH_DATA, DATA):
        p = root / name
        if p.is_file():
            return p.read_bytes()
    raise FileNotFoundError(name)


def corpus_files() -> list[str]:
    """Benchmark sweep files, mirroring Test.scala:61-66's selection
    (no '_'-suffixed bank splits, size < 5e6)."""
    if not BENCH_DATA.is_dir():
        return []
    out = []
    for p in sorted(BENCH_DATA.iterdir()):
        if "_" in p.name or p.stat().st_size >= 5_000_000:
            continue
        typ = p.name.partition("-")[0]
        if typ not in TYPES or p.stat().st_size == 0:
            continue  # stray/empty fixtures (e.g. the empty alignerTestData)
        out.append(p.name)
    return out


class _JavaRandom:
    """java.util.Random's 48-bit LCG — RandomFileGenerator uses
    `new Random(4444)` (DataGenerator.scala:13), and reproducing it
    bit-exactly lets synth() REGENERATE data/randomASCII.txt rather than
    approximate it (tests assert equality against the mounted file)."""

    _MULT = 0x5DEECE66D
    _MASK = (1 << 48) - 1

    def __init__(self, seed: int):
        self.seed = (seed ^ self._MULT) & self._MASK

    def _next(self, bits: int) -> int:
        self.seed = (self.seed * self._MULT + 0xB) & self._MASK
        return self.seed >> (48 - bits)

    def next_int(self, bound: int) -> int:
        if bound & (bound - 1) == 0:  # power of two
            return (bound * self._next(31)) >> 31
        while True:
            bits = self._next(31)
            val = bits % bound
            if bits - val + (bound - 1) < (1 << 31):  # no int32 overflow
                return val


def synth(kind: str, size: int, seed: int = 4444) -> bytes:
    """Synthesize corpus data, byte-identical to DataGenerator.scala:

    random    — `new Random(4444).nextInt(93) + 32` ASCII stream
                (RandomFileGenerator; regenerates data/randomASCII.txt and
                every random-<n>.txt prefix exactly)
    repeating — all 'a' (DataGenerator's repeatingWriter)
    real      — prefix of data/all-mtg-cards.txt (DataGenerator's
                realWriter; a repeating+random stand-in only when the
                corpus is not mounted)
    """
    if kind == "random":
        rand = _JavaRandom(seed)
        return bytes(rand.next_int(93) + 32 for _ in range(size))
    if kind == "repeating":
        return b"a" * size
    if kind == "real":
        try:
            data = load("all-mtg-cards.txt")
        except FileNotFoundError:
            data = synth("repeating", size * 4, seed) + synth("random", size, seed)
            return data[:size]
        # DataGenerator reads the corpus as a UTF-8 STRING and writes
        # `allMTGCards(i).toByte.toChar` — i.e. the i-th CHARACTER's
        # codepoint truncated to a byte (em-dash U+2014 -> 0x14). Mirror
        # that quirk exactly: real-<n>.txt files are char-prefixes, not
        # byte-prefixes, of all-mtg-cards.txt.
        chars = data.decode("utf-8")[:size]
        return bytes(ord(c) & 0xFF for c in chars)
    raise ValueError(kind)
