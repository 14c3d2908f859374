"""The codec's spans (`utils.profiling.span`, recorded under `tracing()`).

With recording off a span is one shared no-op and the bytes are the
same as with it on. With it on, each `api.compress` call is one tree:
the `api.compress` root, its `api.*` stages once each, `encode.corpus`
with one `encode.wave` a wave, and the match, candidate, commit and emit
stages under each wave, each child inside its parent's time. Under
torch.profiler every span has its `snappy.<name>` range, and no span
waits for the card. Three blocks at wave 1, on the CPU.
"""

import collections
import os
import sys
import threading

import numpy as np
import pytest
import torch

from tpu_snappy_torch import api
from tpu_snappy_torch.config import DEFAULT_CONFIG, TURBO_CONFIG
from tpu_snappy_torch.ops import encode
from tpu_snappy_torch.utils import profiling

from torch_threads import share_cores

share_cores()

WAVES = 3
API = ("api.prepare", "api.h2d", "encode.corpus", "api.fetch", "api.join")
WAVE = ("encode.match", "encode.commit", "encode.emit")


def _data(seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    words = [b"snappy ", b"block ", b"stream", b"copy ", b"literal "]
    text = b"".join(words[i] for i in rng.integers(0, len(words), 40000))
    noise = rng.integers(0, 256, 20000, dtype=np.uint8).tobytes()
    return (text + noise + text)[:WAVES * 65536 - 123]


def _compress(cfg=DEFAULT_CONFIG, seed: int = 0) -> bytes:
    return api.compress(_data(seed), cfg, device="cpu", wave=1)


def _children(spans):
    kids = collections.defaultdict(list)
    for s in spans:
        kids[s.parent].append(s)
    return kids


def _names(spans) -> list:
    return sorted(s.name for s in spans)


def test_recording_off_records_nothing_and_keeps_the_bytes():
    assert profiling.span("api.compress") is profiling.span("encode.wave")
    with profiling.tracing() as rec:
        pass
    off = _compress()
    assert rec.spans == [] and profiling.recorder() is None
    with profiling.tracing() as rec:
        on = _compress()
    assert on == off and rec.spans
    assert profiling.recorder() is None


@pytest.mark.parametrize("cfg", [DEFAULT_CONFIG, TURBO_CONFIG],
                         ids=["default", "turbo"])
def test_each_call_is_one_tree_of_spans(cfg):
    with profiling.tracing() as rec:
        for seed in (0, 1):
            _compress(cfg, seed)
    spans = rec.spans
    by_index = {s.index: s for s in spans}
    assert sorted(by_index) == list(range(len(spans)))
    kids = _children(spans)
    roots = kids[-1]
    assert [r.name for r in roots] == ["api.compress"] * 2
    assert [r.call for r in roots] == [0, 1]
    for root in roots:
        assert _names(kids[root.index]) == sorted(API)
        corpus, = [s for s in kids[root.index] if s.name == "encode.corpus"]
        waves = [s for s in kids[corpus.index] if s.name == "encode.wave"]
        assert _names(kids[corpus.index]) == ["encode.compact"] + [
            "encode.wave"] * WAVES
        for wave in waves:
            assert _names(kids[wave.index]) == sorted(WAVE)
            match, = [s for s in kids[wave.index]
                      if s.name == "encode.match"]
            assert _names(kids[match.index]) == ["encode.candidates"]
        # The stages follow each other in the call's order.
        stages = sorted(kids[root.index], key=lambda s: s.t0)
        assert [s.name for s in stages] == list(API)
    for s in spans:
        assert s.t0 <= s.t1 and s.thread == threading.get_ident()
        if s.parent >= 0:
            up = by_index[s.parent]
            assert up.t0 <= s.t0 and s.t1 <= up.t1, (up, s)
            assert up.call == s.call and up.index < s.index
    calls = collections.Counter(s.call for s in spans)
    assert calls[0] == calls[1] == 1 + len(API) + WAVES * 5 + 1


def test_a_span_opened_alone_starts_a_call():
    blocks = torch.zeros((2, 65536), dtype=torch.uint8)
    lengths = torch.tensor([65536, 300], dtype=torch.int32)
    with profiling.tracing() as rec:
        encode.encode_corpus_compact(blocks, lengths, TURBO_CONFIG, wave=2)
        encode.encode_corpus_compact(blocks, lengths, TURBO_CONFIG, wave=1)
    roots = _children(rec.spans)[-1]
    assert [(r.name, r.call) for r in roots] == [("encode.corpus", 0),
                                                 ("encode.corpus", 1)]
    assert collections.Counter(s.name for s in rec.spans)[
        "encode.wave"] == 3


@pytest.mark.parametrize("ranges", [True, False])
def test_every_span_has_its_profiler_range(ranges):
    """ranges=False records the same spans and opens no range."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with profiling.tracing(ranges) as rec:
            assert profiling.recorder() is rec
            _compress(TURBO_CONFIG)
    assert profiling.recorder() is None
    got = collections.Counter(
        e.name[len(profiling.RANGE_PREFIX):] for e in prof.events()
        if e.name.startswith(profiling.RANGE_PREFIX))
    names = collections.Counter(s.name for s in rec.spans)
    assert names["encode.wave"] == WAVES
    assert got == (names if ranges else collections.Counter())


def test_no_span_waits_for_the_card(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span waited for the card")
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    with profiling.tracing() as rec:
        got = _compress(TURBO_CONFIG)
    assert got == api.compress(_data(), TURBO_CONFIG, device="cpu")
    assert len(rec.spans) == 1 + len(API) + WAVES * 5 + 1


def test_threads_keep_their_own_trees():
    with profiling.tracing() as rec:
        workers = [threading.Thread(target=_compress, args=(TURBO_CONFIG,))
                   for _ in range(2)]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
    by_index = {s.index: s for s in rec.spans}
    roots = [s for s in rec.spans if s.parent == -1]
    assert sorted(r.call for r in roots) == [0, 1]
    assert len({r.thread for r in roots}) == 2
    for s in rec.spans:
        if s.parent >= 0:
            assert by_index[s.parent].thread == s.thread
            assert by_index[s.parent].call == s.call


def test_an_inner_block_records_apart_and_the_outer_resumes():
    with profiling.tracing() as outer:
        with profiling.span("encode.corpus"):
            with profiling.tracing() as inner:
                with profiling.span("encode.wave"):
                    pass
            with profiling.span("encode.compact"):
                pass
    assert [(s.name, s.parent) for s in inner.spans] == [("encode.wave",
                                                          -1)]
    assert [s.name for s in outer.spans] == ["encode.compact",
                                             "encode.corpus"]
    assert outer.spans[0].parent == outer.spans[1].index


def test_many_threads_lose_no_span():
    """More threads than cores, switching often: every span is kept once,
    with its own thread's parent and call."""
    threads, calls, depth = 4 * (os.cpu_count() or 1), 30, 3

    def work():
        for _ in range(calls):
            with profiling.span("api.compress"):
                for _ in range(depth):
                    with profiling.span("encode.wave"):
                        with profiling.span("encode.commit"):
                            pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.tracing() as rec:
            workers = [threading.Thread(target=work) for _ in range(threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    total = threads * calls * (1 + 2 * depth)
    assert sorted(s.index for s in rec.spans) == list(range(total))
    by_index = {s.index: s for s in rec.spans}
    roots = [s for s in rec.spans if s.parent == -1]
    assert sorted(r.call for r in roots) == list(range(threads * calls))
    for s in rec.spans:
        if s.parent >= 0:
            up = by_index[s.parent]
            assert (up.thread, up.call) == (s.thread, s.call)
            assert up.name == {"encode.wave": "api.compress",
                               "encode.commit": "encode.wave"}[s.name]
