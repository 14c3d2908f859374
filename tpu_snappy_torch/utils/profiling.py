"""Tracing and timing on the card (the port's counterpart of
tpu_snappy/utils/profiling.py).

  * `trace(path)`    — a torch.profiler trace of the CPU and the card,
                       written as a Chrome trace (open it in Perfetto).
  * `tracing()`      — record the codec's spans (`span(name)`) for the
                       block: each span's host start and end, never
                       waiting for the card, and under a profiler a
                       `snappy.<name>` range beside the card's work.
  * `sync` / `sync1` — wait for the card behind every tensor of a tree,
                       or behind its first one only.
  * `device_bench()` — seconds a call on the card, from CUDA events
                       around a batch of calls (best of several trials);
                       on the CPU, the host clock around the same batch.
"""

from __future__ import annotations

import collections
import contextlib
import os
import tempfile
import threading
import time

import torch

#: Prefix of a span's range in a profiler trace.
RANGE_PREFIX = "snappy."

#: One closed span. `index` numbers the spans in the order they opened;
#: `parent` is the index of the span open around it on its thread (-1
#: for none); `call` is the call id, new at each span opened with no
#: parent (`api.compress` opens one a call) and shared by what opens
#: inside it; `t0` and `t1` are `time.perf_counter_ns()` readings.
Span = collections.namedtuple(
    "Span", "index name call parent thread t0 t1")


class Recorder:
    """The spans of one `tracing()` block: `spans` lists each closed span
    in the order it closed (a span still open is not there yet)."""

    def __init__(self, ranges: bool = True):
        self.ranges = ranges
        self.spans: list = []
        self._opened = 0
        self._calls = 0
        self._stacks: dict = {}  # thread id -> its open spans, innermost last
        self._lock = threading.Lock()


class _Open:
    """A span while it is open (recording on)."""

    __slots__ = ("rec", "name", "index", "call", "parent", "thread", "t0",
                 "range")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name, self.range = rec, name, None

    def __enter__(self):
        rec, self.thread = self.rec, threading.get_ident()
        with rec._lock:
            stack = rec._stacks.setdefault(self.thread, [])
            self.index = rec._opened
            rec._opened += 1
            if stack:
                self.parent, self.call = stack[-1].index, stack[-1].call
            else:
                self.parent, self.call = -1, rec._calls
                rec._calls += 1
            stack.append(self)
        if rec.ranges:
            self.range = torch.profiler.record_function(RANGE_PREFIX
                                                        + self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        rec = self.rec
        with rec._lock:
            rec._stacks[self.thread].pop()
            rec.spans.append(Span(self.index, self.name, self.call,
                                  self.parent, self.thread, self.t0, t1))
        return False


#: The recorder of the innermost open `tracing()` block, None while
#: recording is off.
_recorder: Recorder | None = None
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager around one stage of the codec. With recording
    off it is a shared no-op; with it on, the stage's host start and end
    are kept and a `snappy.<name>` profiler range covers it. It never
    waits for the card: the card's share of a stage is the trace's."""
    rec = _recorder
    if rec is None:
        return _OFF
    return _Open(rec, name)


def recorder() -> Recorder | None:
    """The recorder of the innermost open `tracing()` block, None while
    recording is off."""
    return _recorder


@contextlib.contextmanager
def tracing(ranges: bool = True):
    """Record every `span` opened in the block, on any thread, into a new
    Recorder, which it yields; the recording that was on before (if any)
    resumes after the block. ranges=False keeps the host clock alone: no
    span opens a profiler range (for a profiled run whose reduction takes
    every range it does not know for the card's work)."""
    global _recorder
    outer, rec = _recorder, Recorder(ranges)
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = outer


def _default_trace_path() -> str:
    return os.path.join(tempfile.gettempdir(), "tpu_snappy_torch_trace.json")


@contextlib.contextmanager
def trace(path: str | None = None):
    """torch.profiler over the block (CPU and, where visible, CUDA
    activity); the Chrome trace goes to `path` on exit. Yields the path.
    Spans recorded under `tracing()` inside it show there as
    `snappy.<name>` ranges above the kernels they launched."""
    path = path or _default_trace_path()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield path
    prof.export_chrome_trace(path)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def sync(tree=None) -> None:
    """Wait for the card to finish the work behind every CUDA tensor of
    `tree` (any nesting of tuples, lists and dicts); a no-op for CPU
    tensors."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


def sync1(tree) -> None:
    """Wait for the device of the first tensor of `tree` (profiling.py:66):
    a card's queue runs in order, so the latest work on it bounds every
    earlier launch there, and one synchronise is the whole wait. A no-op
    for a CPU tensor or a tree without one."""
    leaf = next(_tensors(tree), None)
    if leaf is not None and leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)


def device_bench(fn, *args, iters: int = 30, trials: int = 3,
                 device=None) -> float:
    """Best-of-trials seconds per call of fn(*args): one warm-up call,
    then `iters` calls between two CUDA events on `device` (default: the
    device of the first tensor argument), read after one synchronise. For
    CPU arguments the host clock times the same batch."""
    if device is None:
        device = next((a.device for a in args
                       if isinstance(a, torch.Tensor)), torch.device("cpu"))
    device = torch.device(device)
    fn(*args)
    best = float("inf")
    for _ in range(trials):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.cuda.device(device):
                start.record()
                for _ in range(iters):
                    fn(*args)
                end.record()
            end.synchronize()
            sec = start.elapsed_time(end) / 1e3 / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            sec = (time.perf_counter() - t0) / iters
        best = min(best, sec)
    return best
