"""Tracing and timing on the card (the port's counterpart of
tpu_snappy/utils/profiling.py).

  * `trace(path)`    — a torch.profiler trace of the CPU and the card,
                       written as a Chrome trace (open it in Perfetto).
  * `sync` / `sync1` — wait for the card behind every tensor of a tree,
                       or behind its first one only.
  * `Timer`          — named wall-clock sections, each synchronised with
                       the card at its end.
  * `device_bench()` — seconds a call on the card, from CUDA events
                       around a batch of calls (best of several trials);
                       on the CPU, the host clock around the same batch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time

import torch


def _default_trace_path() -> str:
    return os.path.join(tempfile.gettempdir(), "tpu_snappy_torch_trace.json")


@contextlib.contextmanager
def trace(path: str | None = None):
    """torch.profiler over the block (CPU and, where visible, CUDA
    activity); the Chrome trace goes to `path` on exit. Yields the path."""
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


@dataclasses.dataclass
class Timer:
    """Named wall-clock sections with device sync at section end."""
    sections: dict = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def section(self, name: str, result=None):
        t0 = time.perf_counter_ns()
        yield
        if result is not None:
            sync(result)
        self.sections[name] = self.sections.get(name, 0) + \
            time.perf_counter_ns() - t0

    def report(self) -> str:
        total = sum(self.sections.values())
        lines = [f"{k:24s} {v/1e6:9.2f} ms ({100*v/max(1,total):4.1f}%)"
                 for k, v in self.sections.items()]
        return "\n".join(lines)


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
