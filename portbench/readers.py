"""Arithmetic the metrics' readers share (metrics/*.py).

A reader takes the run's observations (harness.run_cell): in every run
`calls` (each API call's input index, host-clock start and end in ns,
bytes in and out), `window_s`, `setup_s`, the window's
`memory_peak_bytes` and the `call_bytes` of an input; in a traced run
also `spans` ((name, call, start_ns, end_ns) of the functions the
metrics name, each waited for at its end), `counters`, `kernels` (each
outermost kernel wrapper call's name, the spans open around it, its
bound in seconds and its device seconds from the trace) and `device`
(busy and window seconds from the trace, None without a card). It
returns None where it finds nothing to read. A metric's unit, layer,
direction and the metric it moves are its BENCHMARK.json entry's.
"""

from __future__ import annotations


def span_s(obs: dict, name: str) -> float:
    """Seconds spent in span `name` over the window."""
    return sum(t1 - t0 for n, _, t0, t1 in obs["spans"] if n == name) / 1e9


def span_count(obs: dict, name: str) -> int:
    return sum(1 for n, *_ in obs["spans"] if n == name)


def calls_s(obs: dict) -> float:
    """Seconds of the window's API calls."""
    return sum(c["t1"] - c["t0"] for c in obs["calls"]) / 1e9


def share(part: float, whole: float):
    """100 * part / whole, or None where whole is 0 or part is."""
    return 100.0 * part / whole if whole > 0 and part > 0 else None


def outside_share(obs: dict, name: str):
    """Percent of the API calls' time outside span `name`."""
    whole = calls_s(obs)
    if not span_count(obs, name) or whole <= 0:
        return None
    return 100.0 * (whole - span_s(obs, name)) / whole


def mean_ms(obs: dict, name: str):
    count = span_count(obs, name)
    return span_s(obs, name) / count * 1e3 if count else None


def roofline(obs: dict, inside: str | None = None):
    """Percent: the kernel calls' bounds summed over their device seconds
    summed, of every outermost kernel call or of those inside span
    `inside`."""
    ks = [k for k in obs["kernels"]
          if k["device_s"] is not None and (inside is None
                                            or inside in k["stack"])]
    return share(sum(k["bound_s"] for k in ks),
                 sum(k["device_s"] for k in ks))


def idle_pct(obs: dict):
    dev = obs["device"]
    if not dev or dev["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])


def done_in(obs: dict) -> int:
    """Input bytes of the window's calls that returned."""
    return sum(c["in"] for c in obs["calls"] if c["out"] is not None)


def done_out(obs: dict) -> int:
    """Bytes the window's calls that returned gave back."""
    return sum(c["out"] for c in obs["calls"] if c["out"] is not None)
