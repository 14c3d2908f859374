"""The controls of the cells' checks: for each input a run checks, the
entry's `control(k)` (the plain reference put in the program's place with
one guarantee of the configuration broken; entries/<entry>.py says
which) is held to the entry's own check, which has to fail it.

    python3 portbench/control.py --workload raw-default.write \
        --seeds 11,12,13

runs a cell's control at the cell's own sizes (on the card, where the
entry's set-up uses it) and prints each seed's numbers beside their
limits. The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

if __name__ == "__main__":
    sys.path[0] = str(pathlib.Path(__file__).resolve().parent.parent)


def control_reading(name: str, seed: int, *, device: str = "cuda",
                    sizes: dict | None = None,
                    bench: dict | None = None) -> dict:
    """The cell's check on the control's outputs for `seed`, one on each
    of the cell's inputs, as a window that takes them all is checked.
    `sizes` and `bench` as in harness.run_cell."""
    from portbench import harness
    spec = harness.cell_spec(name, bench)
    _, inputs, entry = harness.inputs_and_entry(spec, seed, device, sizes)
    return entry.check([(k, entry.control(k)) for k in range(len(inputs))])


def main() -> int:
    ap = argparse.ArgumentParser(description="run a cell's control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    args = ap.parse_args()
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        for key, (value, limit, op) in control_reading(
                args.workload, seed).items():
            print(f"control {args.workload} seed {seed}: {key} {value} "
                  f"(limit {op} {limit}; {time.perf_counter() - t0:.1f} s)",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
