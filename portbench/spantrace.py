"""A traced run of one cell read by the program's spans, or the cost of
recording them.

    python3 portbench/spantrace.py --workload raw-default.write \
        --seed 7 --seconds 51
    python3 portbench/spantrace.py --workload raw-turbo.write --seed 7 \
        --cost 20

The first is `run.py --trace 1` with the program's recording on (its
`snappy.` ranges included) for the measured window alone: it prints that
run's result line, whose metrics read as without the ranges (probe.py's
reduction is handed the trace without them), then one JSON line of what
the program's spans show (spans.reduce_program): by span, host ms a call
and device ms and operations a call and a wave; idle seconds by span;
the share of the linked device seconds launched inside a span; and the
share of each call's `api.compress` that its stages cover.

The second times `api.compress` of the cell's first input, recording
off, on, and on with the host clock alone, in turns for `--cost` rounds,
once without a profiler and once under one, and prints ms a call, with
ns a span of 20,000 empty spans in each state and the spans a call
opens. Both print the card's name and power limit on standard error.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402

sys.path[0] = str(pathlib.Path(__file__).resolve().parent.parent)
os.environ.setdefault("USE_FLAX", "0")

#: The stages of one api.compress call, in order.
STAGES = ("api.prepare", "api.h2d", "encode.corpus", "api.fetch",
          "api.join")


def host_by_span(records) -> dict:
    """Host ms a call by span name, and the least and mean share of a
    call's api.compress that STAGES cover, from a Recorder's spans."""
    roots = {s.index: s for s in records if s.name == "api.compress"}
    ns, covered = defaultdict(int), defaultdict(int)
    for s in records:
        ns[s.name] += s.t1 - s.t0
        if s.parent in roots and s.name in STAGES:
            covered[s.parent] += s.t1 - s.t0
    shares = [covered[i] / (r.t1 - r.t0) for i, r in roots.items()]
    calls = max(1, len(roots))
    return {"calls": len(roots),
            "host_ms_per_call": {k: v / calls / 1e6 for k, v in ns.items()},
            "stage_cover_min": min(shares, default=None),
            "stage_cover_mean": (statistics.fmean(shares) if shares
                                 else None)}


def traced(cell: str, seed: int, seconds: float) -> list:
    import torch  # noqa: F401
    from portbench import harness, probe, spans
    from tpu_snappy_torch.utils import profiling
    found = {}
    real_window, real_reduce = harness._window, probe.reduce_trace

    def window(*args, **kwargs):
        with profiling.tracing() as rec:
            found["records"] = rec
            return real_window(*args, **kwargs)

    def reduce(events, kernel_calls):
        events = list(events)
        found.update(spans.reduce_program(events))
        return real_reduce(spans.without_program(events), kernel_calls)

    harness._window, probe.reduce_trace = window, reduce
    result = harness.run_cell(cell, seed, seconds, True, started=STARTED)
    prog = host_by_span(found.pop("records").spans)
    calls = max(1, prog["calls"])
    waves = max(1, found.get("program_spans", {}).get("encode.wave", 0))
    dev, ops = found.get("program_device_s", {}), found.get("program_ops",
                                                            {})
    idle = found.get("idle_s") or 0.0
    gaps = found.get("idle_gaps", {})
    prog.update({
        "waves": waves,
        "device_ms_per_call": {k: v / calls * 1e3 for k, v in dev.items()},
        "device_ms_per_wave": {k: v / waves * 1e3 for k, v in dev.items()},
        "ops_per_call": {k: v / calls for k, v in ops.items()},
        "ops_per_wave": {k: v / waves for k, v in ops.items()},
        "idle_s": idle,
        "idle_gaps": dict(sorted(gaps.items(), key=lambda kv: -kv[1])),
        "idle_share_api_compress_alone": (gaps.get("api.compress", 0.0)
                                          / idle if idle else None),
        "idle_share_no_program_span": (found["idle_outside_s"] / idle
                                       if idle else None),
        "linked_s": found.get("linked_s"),
        "attributed_share": (found["attributed_s"] / found["linked_s"]
                             if found.get("linked_s") else None)})
    return [result, prog]


def cost(cell: str, seed: int, rounds: int) -> dict:
    import torch
    from portbench import harness
    from tpu_snappy_torch.utils import profiling
    spec = harness.cell_spec(cell)
    _, _, entry = harness.inputs_and_entry(spec, seed, "cuda")
    entry.warm_up()
    modes = {"off": contextlib.nullcontext,
             "on": profiling.tracing,
             "on_host_clock": lambda: profiling.tracing(ranges=False)}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with profiling.tracing(ranges=False) as rec:
        entry.call(0)
    out = {"rounds": rounds, "spans_per_call": len(rec.spans)}
    for profiled in (False, True):
        ms = {m: [] for m in modes}
        span_ns = {}
        with (torch.profiler.profile(activities=acts) if profiled
              else contextlib.nullcontext()):
            for r in range(rounds):
                for m in (list(modes) if r % 2 == 0 else list(modes)[::-1]):
                    with modes[m]():
                        t0 = time.perf_counter_ns()
                        entry.call(0)
                        ms[m].append((time.perf_counter_ns() - t0) / 1e6)
            for m in modes:
                with modes[m]():
                    t0 = time.perf_counter_ns()
                    for _ in range(20000):
                        with profiling.span("encode.wave"):
                            pass
                    span_ns[m] = (time.perf_counter_ns() - t0) / 20000
        out["profiled" if profiled else "plain"] = {
            m: {"mean": statistics.fmean(v), "median": statistics.median(v),
                "min": min(v), "max": max(v), "span_ns": span_ns[m]}
            for m, v in ms.items()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--cost", type=int, default=0)
    args = ap.parse_args()
    from portbench import harness
    try:
        if args.cost:
            info = harness.card(1)
            print(f"card: {info['kind']}; nvidia-smi name, power limit: "
                  f"{info['smi']}", file=sys.stderr, flush=True)
            lines = [cost(args.workload, args.seed, args.cost)]
        else:
            lines = traced(args.workload, args.seed, args.seconds)
    except harness.RunError as err:
        print(f"spantrace: {err}", file=sys.stderr)
        return err.code
    for line in lines:
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
