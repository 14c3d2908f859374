"""Spans, counters and kernel calls of a traced run, and the reduction
of its profiler trace.

The benchmark places its spans itself, at run time, around the program's
functions that the cell's per-layer metrics name ("module:attr"), and
around every kernel wrapper of `tpu_snappy_torch.ops.kernels` (each
function there that counts its `launches`). A span waits for the card
at its end, so that it holds the device work its function queued; a
kernel wrapper's call is marked for the profiler only. Nothing is
wrapped in a run with `--trace 0`.
"""

from __future__ import annotations

import bisect
import importlib
import pkgutil
import sys
import time
from collections import defaultdict

import torch

from . import yardstick

#: Host calls that launch work on the card (the CUDA API's cuda* and cu*
#: calls), whose correlation id the device operation carries.
LAUNCH_PREFIXES = ("cuda", "cu")
PREFIX = "pb."


def kernel_wrappers() -> dict:
    """{(module, name): function} of the port's kernel wrappers: the
    public functions of the modules of tpu_snappy_torch.ops.kernels that
    count their launches."""
    pkg = importlib.import_module("tpu_snappy_torch.ops.kernels")
    found = {}
    for info in pkgutil.iter_modules(pkg.__path__):
        mod = importlib.import_module(f"{pkg.__name__}.{info.name}")
        for name, fn in vars(mod).items():
            if (callable(fn) and not name.startswith("_")
                    and hasattr(fn, "launches")
                    and getattr(fn, "__module__", None) == mod.__name__):
                found[(mod, name)] = fn
    return found


class Probe:
    """Wraps the named functions and the kernel wrappers for one run.
    `call` is the index of the API call running now (the window sets it);
    `spans` holds (name, call, start_ns, end_ns) on the host clock,
    `counters` {name: [(call, value)]}, `kernels` (call, wrapper name,
    the span names open around it) for each outermost kernel call, and in
    `bounding` mode `bounds` (wrapper name, seconds, "bytes" or
    "operations") instead."""

    def __init__(self, targets: dict, cuda: bool):
        self.targets = targets  # "module:attr" -> counter function or None
        self.cuda = cuda
        self.call = -1
        self.recording = True
        self.bounding = False
        self.stack: list = []
        self.in_kernel = False
        self.spans, self.kernels, self.bounds = [], [], []
        self.counters = defaultdict(list)
        self._undo = []

    def reset(self) -> None:
        """Forget what was recorded so far (the warm-up's calls)."""
        self.spans, self.kernels, self.bounds = [], [], []
        self.counters.clear()

    def install(self) -> None:
        for target, counter in self.targets.items():
            modname, attr = target.split(":")
            mod = importlib.import_module(modname)
            self._patch(mod, attr, self._span(attr, getattr(mod, attr),
                                              counter))
        for (mod, name), fn in kernel_wrappers().items():
            self._patch(mod, name, self._kernel(name, fn))

    def uninstall(self) -> None:
        for mod, attr, fn in reversed(self._undo):
            setattr(mod, attr, fn)
        self._undo.clear()

    def _patch(self, mod, attr, fn) -> None:
        self._undo.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, fn)

    def _span(self, name, fn, counter):
        def spanned(*args, **kwargs):
            self.stack.append(name)
            t0 = time.perf_counter_ns()
            try:
                with torch.profiler.record_function(PREFIX + "span." + name):
                    out = fn(*args, **kwargs)
                    if self.cuda:
                        torch.cuda.synchronize()
            finally:
                self.stack.pop()
            if self.recording:
                self.spans.append((name, self.call, t0,
                                   time.perf_counter_ns()))
                if counter is not None:
                    for key, value in counter(out).items():
                        self.counters[key].append((self.call, value))
            return out
        return spanned

    def _kernel(self, name, fn):
        def marked(*args, **kwargs):
            if self.in_kernel:
                return fn(*args, **kwargs)
            self.in_kernel = True
            try:
                if self.bounding:
                    out = fn(*args, **kwargs)
                    self.bounds.append((name, *yardstick.bound(
                        name, (*args, *kwargs.values()), out)))
                    return out
                with torch.profiler.record_function(PREFIX + "kernel."
                                                    + name):
                    out = fn(*args, **kwargs)
                if self.recording:
                    self.kernels.append((self.call, name, tuple(self.stack)))
                return out
            finally:
                self.in_kernel = False
        # A wrapper counts its launches on the module's name for it, which
        # is this function while it is installed.
        marked.launches = fn.launches
        return marked


def _span_ns(event) -> tuple[int, int]:
    """(start, end) of a kineto event in ns (older torch gives us)."""
    if hasattr(event, "start_ns"):
        return event.start_ns(), event.start_ns() + event.duration_ns()
    return event.start_us() * 1000, (event.start_us()
                                     + event.duration_us()) * 1000


def reduce_trace(events, kernel_calls: int) -> dict:
    """What the card did in a profiled window, from kineto's events (on
    the card, every one but the mirrors of the benchmark's spans is a
    kernel, memset or copy):
    `busy_s` (the union of its busy intervals inside the window, the first
    API call's start to the last one's end), `window_s`, `kernel_device_s`
    (device seconds launched inside each marked kernel call, in order;
    None where the marks do not number `kernel_calls`), `device_ops`
    (seconds by device operation name) and `idle_gaps` (idle seconds by
    the innermost benchmark span open on the host in the gap's middle)."""
    ranges, launches, busy = [], {}, []
    for e in events:
        name = e.name()
        t0, t1 = _span_ns(e)
        on_cpu = e.device_type() == torch.autograd.DeviceType.CPU
        if name.startswith(PREFIX):
            if on_cpu:
                ranges.append((t0, t1, name[len(PREFIX):]))
        elif on_cpu:
            if name.startswith(LAUNCH_PREFIXES):
                launches[e.correlation_id()] = t0
        else:
            busy.append((t0, t1, name, e.correlation_id()))
    ranges.sort()
    calls = [r for r in ranges if r[2] == "call"]
    if not calls:
        return {}
    lo, hi = calls[0][0], max(r[1] for r in calls)
    marks = [r for r in ranges if r[2].startswith("kernel.")]
    starts = [r[0] for r in marks]
    per_mark = [0.0] * len(marks)
    ops = defaultdict(float)
    for b0, b1, name, corr in busy:
        ops[name[:120]] += (b1 - b0) / 1e9
        t = launches.get(corr)
        if t is None:
            continue
        j = bisect.bisect_right(starts, t) - 1
        if j >= 0 and marks[j][1] >= t:
            per_mark[j] += (b1 - b0) / 1e9
    busy_s, gaps = _union(busy, lo, hi)
    linked = sum(1 for *_, corr in busy if corr in launches)
    print(f"trace: {len(ranges)} benchmark spans, {len(launches)} "
          f"launches; {linked} of {len(busy)} device operations linked to "
          f"their launch; {len(marks)} kernel marks, {kernel_calls} kernel "
          "calls", file=sys.stderr)
    return {"busy_s": busy_s, "window_s": (hi - lo) / 1e9,
            "kernel_device_s": per_mark if len(marks) == kernel_calls
            else None,
            "device_ops": dict(ops), "idle_gaps": _name_gaps(gaps, ranges)}


def _union(intervals, lo: int, hi: int):
    """Length in seconds of the union of the intervals clipped to [lo,
    hi], and the gaps between them there."""
    busy, gaps, at = 0, [], lo
    for s, e, *_ in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= at:
            continue
        if s > at:
            gaps.append((at, s))
        busy += e - max(s, at)
        at = e
    if at < hi:
        gaps.append((at, hi))
    return busy / 1e9, gaps


def _name_gaps(gaps, ranges) -> dict:
    """Idle seconds by the innermost benchmark span open at each gap's
    middle ("harness" where none is)."""
    named = defaultdict(float)
    stack, j = [], 0
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while j < len(ranges) and ranges[j][0] <= mid:
            while stack and stack[-1][1] < ranges[j][0]:
                stack.pop()
            stack.append(ranges[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        named[stack[-1][2] if stack else "harness"] += (g1 - g0) / 1e9
    return dict(named)
