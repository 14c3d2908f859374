"""Benchmark CSV schema + analysis — the csv_scan.py / results-CSV layer
(the port's copy of tpu_snappy/utils/metrics.py).

Reproduces the reference's observability pipeline (SURVEY.md §5): results
CSVs in the `type;length;cycles;compressed-length` schema of
benchmark/hw_results.csv, extended with wall-time and GB/s columns (the
reference never reports GB/s — cycle counts only), plus the ratio /
cycles-per-byte table emitter of benchmark/csv_scan.py.
"""

from __future__ import annotations

import dataclasses
import io
from typing import Iterable

#: Reference CSV header (hw_results.csv:1) + our extensions.
HEADER = "type;length;cycles;compressed-length;wall_ns;GBps"


@dataclasses.dataclass
class Row:
    type: str
    length: int
    wall_ns: int
    compressed_length: int

    @property
    def gbps(self) -> float:
        return self.length / max(1, self.wall_ns)  # bytes/ns == GB/s

    @property
    def ratio(self) -> float:
        return self.length / max(1, self.compressed_length)

    @property
    def cycles(self) -> int:
        """Equivalent cycle count at the reference Rocket's 1 cycle/ns
        convention (sim has no physical clock; ns is the honest analogue)."""
        return self.wall_ns

    def csv(self) -> str:
        return (f"{self.type};{self.length};{self.cycles};"
                f"{self.compressed_length};{self.wall_ns};{self.gbps:.4f}")


def write_csv(rows: Iterable[Row], fp: io.TextIOBase) -> None:
    fp.write(HEADER + "\n")
    for r in rows:
        fp.write(r.csv() + "\n")


def parse_reference_csv(text: str) -> list[Row]:
    """Parse the reference's hw_results.csv / sw_results.csv format."""
    rows = []
    for line in text.splitlines():
        parts = [p for p in line.strip().split(";") if p]
        if len(parts) < 4 or parts[0] == "type":
            continue
        rows.append(Row(parts[0], int(parts[1]), int(parts[2]), int(parts[3])))
    return rows


def summary_table(rows: list[Row]) -> str:
    """The csv_scan.py ratio/efficiency table (type, length, ratio, cyc/B)."""
    out = ["type\tlength\tratio\tns/byte\tGB/s"]
    for r in rows:
        out.append(f"{r.type}\t{r.length}\t{r.ratio:7.4f}\t"
                   f"{r.wall_ns / max(1, r.length):7.3f}\t{r.gbps:7.4f}")
    return "\n".join(out)


def compare(ours: list[Row], theirs: list[Row]) -> str:
    """Side-by-side vs a reference CSV keyed on (type, length)."""
    theirs_by_key = {(r.type, r.length): r for r in theirs}
    out = ["type\tlength\tours_B\tref_B\tours_ns/B\tref_cyc/B"]
    for r in ours:
        t = theirs_by_key.get((r.type, r.length))
        if t is None:
            continue
        out.append(
            f"{r.type}\t{r.length}\t{r.compressed_length}\t{t.compressed_length}"
            f"\t{r.wall_ns / max(1, r.length):.3f}\t{t.cycles / max(1, t.length):.3f}")
    return "\n".join(out)
