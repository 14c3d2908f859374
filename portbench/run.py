"""Run one cell of the benchmark (see portbench/__init__.py).

    python3 portbench/run.py --workload raw-default.write --seed 7 \
        --seconds 10 --trace 0

Prints the card's name, device count and power limit and the set-up time
on standard error, then every number the check compares beside its
limit, and as the last line of standard output the result as one JSON
object. Exits 2 without a result where the card or the cell is missing,
3 where JAX or the JAX package was loaded, 1 on any other failure.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path[0] = str(pathlib.Path(__file__).resolve().parent.parent)
os.environ.setdefault("USE_FLAX", "0")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    from portbench import harness
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), started=STARTED)
    except harness.RunError as err:
        print(f"portbench: {err}", file=sys.stderr)
        return err.code
    for key, c in result["compared"].items():
        print(f"compared {key}: {c['value']} (limit {c['holds']} "
              f"{c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
