"""One run of one cell: set-up, the measured window, the check and the
metrics.

Everything that belongs to one cell is found by name: the cell in
BENCHMARK.json, its configuration's file, `traffic/<traffic>.json`, the
generator and the entry that file names (`generators/<generator>.py`,
`entries/<entry>.py`) and, for each metric the cell reports,
`metrics/<metric>.py`.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
import resource
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
HERE = pathlib.Path(__file__).resolve().parent

#: Top-level module names that no run may load: JAX, and the JAX package
#: the port was made from (compared whole: tpu_snappy_torch passes).
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_snappy")

#: What nvidia-smi reads beside the window: clocks, power, temperature
#: and why the clocks are held down.
CARD_STATE = ("clocks.sm,clocks.mem,power.draw,temperature.gpu,"
              "clocks_throttle_reasons.active")


class RunError(Exception):
    """A run that must end without a result; `code` is its exit code."""

    def __init__(self, message: str, code: int = 1):
        super().__init__(message)
        self.code = code


def forbidden_modules() -> list:
    """The FORBIDDEN top-level names that sys.modules holds."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _for_cell(entries: list, cell: str) -> list:
    return [m for m in entries if cell in m.get("workloads", [cell])]


def cell_spec(name: str, bench: dict | None = None) -> dict:
    """The cell `name` of BENCHMARK.json with what it needs: its
    configuration (the file), its traffic file, and its end-to-end and
    per-layer metric entries."""
    bench = bench or _json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise RunError(f"no cell {name!r} in BENCHMARK.json", 2)
    cell = cells[name]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return {"cell": cell,
            "config": _json(ROOT / config["file"]),
            "traffic": _json(HERE / "traffic" / f"{cell['traffic']}.json"),
            "end_to_end": _for_cell(bench["end_to_end"], name),
            "per_layer": _for_cell(bench["per_layer"], name)}


def load_metric(name: str):
    """The reader of metric `name` (metrics/<name>.py)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _smi(query: str) -> str:
    """nvidia-smi's reading of `query` for the first card, or "not read"."""
    try:
        lines = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        lines = []
    return lines[0] if lines else "not read"


def card(chips: int) -> dict:
    """The card's name, the device count and the power limit; raises
    RunError where fewer than `chips` CUDA devices are visible."""
    import torch
    if not torch.cuda.is_available():
        raise RunError("no CUDA device is visible", 2)
    count = torch.cuda.device_count()
    if count < chips:
        raise RunError(f"the cell needs {chips} CUDA devices, {count} "
                       "are visible", 2)
    return {"kind": torch.cuda.get_device_name(0), "count": count,
            "smi": _smi("name,power.limit")}


def _cpu_s() -> float:
    """This process's CPU seconds, user and system."""
    return sum(resource.getrusage(resource.RUSAGE_SELF)[:2])


class _Sample:
    """One of the window's results on each input it took, drawn from the
    seed: each later result on an input replaces the kept one with
    probability 1 / (results on it so far)."""

    def __init__(self, seed: int):
        self.seen, self.kept = {}, {}
        self.rng = np.random.default_rng([seed, 1])

    def offer(self, k: int, item) -> None:
        self.seen[k] = self.seen.get(k, 0) + 1
        if int(self.rng.integers(0, self.seen[k])) == 0:
            self.kept[k] = item

    def items(self) -> list:
        return sorted(self.kept.items())


def _window(entry, count: int, seconds: float, probe, sample):
    """Call the entry on inputs 0, 1, ..., count - 1, 0, ... one after
    another until `seconds` have passed. Returns each call's record, the
    failures and the window's seconds, the first call's start to the last
    one's end."""
    import torch
    from .probe import PREFIX
    calls, failures = [], []
    t0 = time.perf_counter()
    i = 0
    while True:
        k = i % count
        if probe:
            probe.call = i
        c0 = time.perf_counter_ns()
        try:
            with torch.profiler.record_function(PREFIX + "call"):
                into, out = entry.call(k)
        except Exception as err:  # a failed call counts, the run goes on
            failures.append(f"call {i}: {type(err).__name__}: {err}")
            into, out = 0, None
        calls.append({"k": k, "t0": c0, "t1": time.perf_counter_ns(),
                      "in": into, "out": None if out is None else len(out)})
        if out is not None:
            sample.offer(k, out)
        i += 1
        if time.perf_counter() - t0 >= seconds:
            return calls, failures, time.perf_counter() - t0


def inputs_and_entry(spec: dict, seed: int, device: str,
                     sizes: dict | None = None):
    """The cell's inputs for `seed`, made by the generator its traffic
    file names, and its entry (set up on them). `sizes` replaces the
    traffic file's sizes (the tests' small runs)."""
    from tpu_snappy_torch.config import CodecConfig
    traffic = dict(spec["traffic"], **(sizes or {}))
    inputs = importlib.import_module(
        f"portbench.generators.{traffic['generator']}").inputs(
            traffic, seed % (1 << 64))
    codec = CodecConfig(**spec["config"]["codec"])
    entry = importlib.import_module(
        f"portbench.entries.{traffic['entry']}").Entry(codec, inputs, device)
    return traffic, inputs, entry


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", sizes: dict | None = None,
             bench: dict | None = None, started: float | None = None,
             log=sys.stderr) -> dict:
    """One run of cell `name`. Returns the result object of the
    benchmark's last line (`compared` last). `sizes` replaces the traffic
    file's sizes and `bench` BENCHMARK.json (the tests' small runs, and
    their cells that BENCHMARK.json does not hold); `started` is the
    process's start on the perf_counter clock, from which set-up is
    timed."""
    started = time.perf_counter() if started is None else started
    seed = seed % (1 << 64)
    spec = cell_spec(name, bench)
    cell = spec["cell"]
    import torch
    cuda = device.startswith("cuda")
    info = card(cell["chips"]) if cuda else None
    if info:
        print(f"card: {info['kind']}; devices {info['count']}; "
              f"nvidia-smi name, power limit: {info['smi']}", file=log,
              flush=True)
    import tpu_snappy_torch  # noqa: F401
    if forbidden_modules():
        raise RunError(f"loaded at start-up: {forbidden_modules()}", 3)
    stages = [("start-up", time.perf_counter())]
    metrics = spec["per_layer" if trace else "end_to_end"]
    readers = {m["name"]: load_metric(m["name"]) for m in metrics}
    traffic, inputs, entry = inputs_and_entry(spec, seed, device, sizes)
    stages.append(("inputs and entry set-up", time.perf_counter()))
    probe = None
    if trace:
        from . import probe as probes
        targets = {}
        for reader in readers.values():
            targets.update(getattr(reader, "SPANS", {}))
        probe = probes.Probe(targets, cuda)
        probe.install()
    entry.warm_up()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    stages.append(("warm-up", time.perf_counter()))
    setup_s = stages[-1][1] - started
    parts = ", ".join(f"{name} {t - was}" for (name, t), (_, was) in zip(
        stages, [("", started)] + stages))
    print(f"set-up {setup_s} s: {parts}", file=log, flush=True)

    if cuda:
        print(f"card before the window ({CARD_STATE}): {_smi(CARD_STATE)}",
              file=log, flush=True)
    sample = _Sample(seed)
    prof = None
    if trace:
        probe.reset()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    cpu_s = _cpu_s()
    calls, failures, window_s = _window(entry, len(inputs), seconds, probe,
                                        sample)
    cpu_s = _cpu_s() - cpu_s
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        print(f"card after the window: {_smi(CARD_STATE)}", file=log)
    print(f"host: window {window_s:.3f} s, this process's CPU {cpu_s:.3f} s",
          file=log)
    if probe:
        probe.recording = False
    for line in failures[:5]:
        print(line, file=log)

    took = [(c["t1"] - c["t0"]) / 1e9 for c in calls]
    by_input = {k: round(float(np.mean([t for c, t in zip(calls, took)
                                        if c["k"] == k])), 4)
                for k in sorted({c["k"] for c in calls})}
    print(f"window {window_s} s, {len(calls)} calls of {min(took)} to "
          f"{max(took)} s; mean s by input {by_input}", file=log, flush=True)
    obs = {"calls": calls, "window_s": window_s, "setup_s": setup_s,
           "memory_peak_bytes": peak, "call_bytes": traffic["call_bytes"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": info["kind"] if info else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    breakdown = None
    if trace:
        reduced = time.perf_counter()
        breakdown = _observe(obs, probe, prof, entry, cuda)
        probe.uninstall()
        print(f"trace and bounds {time.perf_counter() - reduced} s",
              file=log, flush=True)
        if obs["device"]:
            dev["busy_s"] = obs["device"]["busy_s"]
            dev["window_s"] = obs["device"]["window_s"]
    values = {}
    for m in metrics:
        value = readers[m["name"]].read(obs)
        if value is not None:
            values[m["name"]] = {"value": value, "unit": m["unit"]}
        elif not trace:
            raise RunError(f"the run gives no {m['name']}")

    # The check, once the window has closed and the peak is read: one
    # result on each input the window took.
    checked = time.perf_counter()
    kept = sample.items()
    compared = {"failed_calls": (len(failures), 0, "<=")}
    compared.update(entry.check(kept))
    print(f"check {time.perf_counter() - checked} s", file=log, flush=True)
    taken = {c["k"] for c in calls if c["out"] is not None}
    compared["checked_inputs"] = (len(kept), max(1, len(taken)), ">=")
    correct = all(v <= lim if op == "<=" else v >= lim
                  for v, lim, op in compared.values())
    result = {"correct": correct, "attempted": len(calls),
              "failed": len(failures), "metrics": values, "device": dev}
    if breakdown:
        result["breakdown"] = breakdown
    if forbidden_modules():
        raise RunError(f"loaded by the run: {forbidden_modules()}", 3)
    result["compared"] = {key: {"value": v, "limit": lim, "holds": op}
                          for key, (v, lim, op) in compared.items()}
    return result


def _observe(obs, probe, prof, entry, cuda):
    """Adds to `obs` what the per-layer readers read: the spans and
    counters, each outermost kernel call with its device seconds (from the
    trace) and bound (from one more call on each input the window took,
    made after it and unprofiled: a call's kernels and their arguments
    follow from its input alone), and the device's busy and idle time.
    Returns the `breakdown` of the result line."""
    calls = obs["calls"]
    obs.update(spans=probe.spans, counters=probe.counters, kernels=[],
               device=None)
    if not cuda:
        return None
    from . import probe as probes
    red = probes.reduce_trace(prof.profiler.kineto_results.events(),
                              len(probe.kernels))
    if not red:
        return None
    obs["device"] = {"busy_s": red["busy_s"], "window_s": red["window_s"]}
    breakdown = {
        "device_ops": sorted(red["device_ops"].items(),
                             key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(red["idle_gaps"].items(),
                            key=lambda kv: -kv[1])[:10]}
    device_s = red["kernel_device_s"]
    bounds = {}
    probe.bounding = True
    for k in sorted({c["k"] for c in calls if c["out"] is not None}):
        probe.bounds = []
        entry.call(k)
        bounds[k] = list(probe.bounds)
    probe.bounding = False
    per_call = {}
    for j, (call, name, stack) in enumerate(probe.kernels):
        per_call.setdefault(call, []).append((j, name, stack))
    for call, marks in per_call.items():
        want = bounds.get(calls[call]["k"], [])
        if [n for _, n, _ in marks] != [b[0] for b in want]:
            print(f"call {call}: its kernel calls differ from the bound "
                  "pass's; the rooflines leave it out", file=sys.stderr)
            continue
        for (j, name, stack), (_, bound_s, by) in zip(marks, want):
            obs["kernels"].append({
                "name": name, "stack": stack, "bound_s": bound_s, "by": by,
                "device_s": None if device_s is None else device_s[j]})
    return breakdown
