"""The program's own spans (`tpu_snappy_torch.utils.profiling.span`) in a
traced run, beside the benchmark's (probe.py).

Host time. The readers of the `api_*` metrics name `HARVEST`, the span
that probe.py already places around `encode_corpus_compact`, with
`harvest` as its counter. Its first call turns the program's recording
on for the rest of the run, on the host clock alone (no profiler range,
so probe.reduce_trace sees the trace it sees without it), or reads the
recording that is on already. Each call then hands on, by span name, the
count and nanoseconds of the spans that closed since the last: a call's
`api.fetch` and `api.join` close after its `encode_corpus_compact`, so
they count at the next call's. A program without the recorder gives
nothing.

Device time. `reduce_program` takes the profiler's events of a window in
which the program's spans opened `snappy.` ranges (`profiling.tracing()`)
and gives each device operation to the innermost program span open at
its launch (by the launch's correlation id, as probe.py gives kernel
marks theirs), and each idle gap to the innermost program span open at
its middle, or where none is, to the benchmark's span as probe.py names
it. `spantrace.py` runs a traced cell with both.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

from . import probe

#: The span whose counter harvests (probe.py's "module:attr" form).
HARVEST = "tpu_snappy_torch.ops.encode:encode_corpus_compact"

#: Prefix of the program's ranges in a trace (profiling.RANGE_PREFIX).
RANGE_PREFIX = "snappy."

class Harvest:
    """The counter of HARVEST (module docstring)."""

    def __init__(self):
        self.held = None          # the tracing() block it opened, if open
        self.rec, self.seen = None, 0   # the recorder read last, its spans

    def __call__(self, _out) -> dict:
        """{"snappy.<name>": (count, ns)} of the program's spans that
        closed since the last call ({} without the recorder)."""
        from tpu_snappy_torch.utils import profiling
        if not hasattr(profiling, "recorder"):
            return {}
        rec = profiling.recorder()
        if rec is None:
            self.held = profiling.tracing(ranges=False)
            rec = self.held.__enter__()
        if rec is not self.rec:
            self.rec, self.seen = rec, 0
        new = rec.spans[self.seen:]
        self.seen += len(new)
        got = {}
        for s in new:
            n, ns = got.get(RANGE_PREFIX + s.name, (0, 0))
            got[RANGE_PREFIX + s.name] = (n + 1, ns + s.t1 - s.t0)
        return got

    def stop(self) -> None:
        """Close the recording it opened, if it did."""
        if self.held is not None:
            self.held.__exit__(None, None, None)
            self.held = None
        self.rec, self.seen = None, 0


harvest = Harvest()


def ms_per_span(obs: dict, name: str):
    """Mean milliseconds of the program's span `name` over what the
    window's harvests handed on, or None where it handed on none."""
    got = [v for _, v in obs["counters"].get(RANGE_PREFIX + name, [])]
    count = sum(n for n, _ in got)
    return sum(ns for _, ns in got) / count / 1e6 if count else None


def without_program(events) -> list:
    """The events but the program's ranges and their device mirrors: the
    trace probe.reduce_trace reads as it was made for."""
    return [e for e in events if not e.name().startswith(RANGE_PREFIX)]


def _innermost(ranges: list, points: list) -> list:
    """For each of the sorted `points`, the innermost of the nested
    `ranges` ((start, end, name), sorted by start, then longest first)
    open at it, or None."""
    out, stack, j = [], [], 0
    for p in points:
        while j < len(ranges) and ranges[j][0] <= p:
            while stack and stack[-1][1] < ranges[j][0]:
                stack.pop()
            stack.append(ranges[j])
            j += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def reduce_program(events) -> dict:
    """What the card did for each program span in a profiled window (the
    first benchmark `call`'s start to the last one's end):
    `program_device_s` and `program_ops` (device seconds and operations by
    the innermost program span open at their launch), `program_spans`
    (ranges by name that opened in the window), `idle_gaps` (idle seconds
    by the innermost program span open at the gap's middle, else the
    benchmark span's name as probe.py gives it, else "harness"),
    `idle_s`, `idle_outside_s` (idle seconds in no program span),
    `linked_s` (device seconds whose launch the trace holds) and
    `attributed_s` (of those, launched inside a program span). {} where
    the trace holds no benchmark call."""
    prog, bench, launches, busy = [], [], {}, []
    for e in events:
        name = e.name()
        t0, t1 = probe._span_ns(e)
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if name.startswith(RANGE_PREFIX):
                prog.append((t0, t1, name[len(RANGE_PREFIX):]))
            elif name.startswith(probe.PREFIX):
                bench.append((t0, t1, name[len(probe.PREFIX):]))
            elif name.startswith(probe.LAUNCH_PREFIXES):
                launches[e.correlation_id()] = t0
        elif not name.startswith((RANGE_PREFIX, probe.PREFIX)):
            busy.append((t0, t1, e.correlation_id()))
    calls = [r for r in bench if r[2] == "call"]
    if not calls:
        return {}
    lo, hi = min(r[0] for r in calls), max(r[1] for r in calls)
    prog.sort(key=lambda r: (r[0], -r[1]))
    bench.sort(key=lambda r: (r[0], -r[1]))
    linked = sorted((launches[c], t1 - t0) for t0, t1, c in busy
                    if c in launches)
    device_s, ops = defaultdict(float), defaultdict(int)
    for (_, dur), r in zip(linked, _innermost(prog, [t for t, _ in linked])):
        if r is not None:
            device_s[r[2]] += dur / 1e9
            ops[r[2]] += 1
    _, gaps = probe._union(busy, lo, hi)
    mids = [(g0 + g1) // 2 for g0, g1 in gaps]
    named, outside = defaultdict(float), 0.0
    for (g0, g1), p, b in zip(gaps, _innermost(prog, mids),
                              _innermost(bench, mids)):
        name = p[2] if p else b[2] if b else "harness"
        named[name] += (g1 - g0) / 1e9
        outside += 0.0 if p else (g1 - g0) / 1e9
    starts = [r[0] for r in prog]
    opened = defaultdict(int)
    for r in prog[bisect.bisect_left(starts, lo):
                  bisect.bisect_right(starts, hi)]:
        opened[r[2]] += 1
    return {"program_device_s": dict(device_s), "program_ops": dict(ops),
            "program_spans": dict(opened), "idle_gaps": dict(named),
            "idle_s": sum(named.values()), "idle_outside_s": outside,
            "linked_s": sum(d for _, d in linked) / 1e9,
            "attributed_s": sum(device_s.values())}
