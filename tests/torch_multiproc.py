"""Several processes over torch.distributed (gloo) running the port's
multi-process entry points: multihost.compress_dp_global and
multihost.compress_multihost on the same input in every process, each
process with its own shards of the global mesh.

`run(data, ...)` launches the workers as subprocesses of this file on a
free localhost port, waits for them with a timeout, kills and reaps every
worker on failure or timeout, and returns what process 0 wrote: its
one-shot stream, its streamed stream and the StreamStats. The tests run
it on the CPU (shards "cpu"); chip_smoke.py runs it with both processes
on one card (shards "cuda:0").

    python tests/torch_multiproc.py --rank R --port P --nprocs N \
        --workdir DIR --shard DEV [--shard DEV ...]     # one worker
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import socket
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def worker(rank: int, port: int, nprocs: int, workdir: pathlib.Path,
           shards: list, blocks_per_wave: int | None, threads: int) -> None:
    sys.path.insert(0, str(ROOT))
    import io

    import torch
    import torch.distributed as dist

    from tpu_snappy_torch.parallel import multihost

    torch.set_num_threads(threads)
    multihost.init_distributed(f"localhost:{port}", num_processes=nprocs,
                               process_id=rank)
    try:
        mesh = multihost.global_mesh(device=tuple(shards))
        assert mesh.world == nprocs and mesh.rank == rank, mesh
        data = (workdir / "input").read_bytes()
        oneshot = multihost.compress_dp_global(data, device=tuple(shards))
        dst = io.BytesIO()
        stats = multihost.compress_multihost(
            io.BytesIO(data), dst, len(data),
            blocks_per_wave=blocks_per_wave, device=tuple(shards))
        if rank == 0:
            (workdir / "oneshot").write_bytes(oneshot)
            (workdir / "stream").write_bytes(dst.getvalue())
            (workdir / "result.json").write_text(json.dumps({
                "processes": nprocs, "global_shards": mesh.size,
                "in_bytes": stats.in_bytes, "out_bytes": stats.out_bytes,
                "waves": stats.waves}))
        else:
            assert not dst.getvalue()  # only process 0 writes
    finally:
        dist.destroy_process_group()


def run(data: bytes, nprocs: int = 2, shards=("cpu", "cpu"),
        blocks_per_wave: int | None = None, timeout: float = 300,
        threads: int = 1) -> dict:
    """Run the workers on `data`; each process holds the `shards` devices.
    Returns process 0's result: the JSON fields plus "oneshot" and
    "stream" (bytes). Raises RuntimeError if a worker fails or the
    timeout passes (every worker is killed and reaped either way)."""
    workdir = pathlib.Path(tempfile.mkdtemp(prefix="torch_multiproc_"))
    try:
        (workdir / "input").write_bytes(data)
        port = _free_port()
        cmd = [sys.executable, str(pathlib.Path(__file__).resolve()),
               "--port", str(port), "--nprocs", str(nprocs),
               "--workdir", str(workdir), "--threads", str(threads)]
        for d in shards:
            cmd += ["--shard", str(d)]
        if blocks_per_wave is not None:
            cmd += ["--blocks-per-wave", str(blocks_per_wave)]
        logs = [open(workdir / f"log{r}", "wb") for r in range(nprocs)]
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=ROOT,
                                  stdout=logs[r], stderr=subprocess.STDOUT)
                 for r in range(nprocs)]
        deadline = time.monotonic() + timeout
        try:
            # A failed worker leaves the others waiting in a collective:
            # stop them all at the first failure, or at the deadline.
            while any(p.poll() is None for p in procs):
                if any(p.poll() for p in procs):
                    break
                if time.monotonic() > deadline:
                    raise RuntimeError(f"workers passed the {timeout} s "
                                       "timeout")
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait(timeout=30)
            for f in logs:
                f.close()
        rcs = [p.returncode for p in procs]
        if any(rcs):
            tail = "\n".join(
                (workdir / f"log{r}").read_text(errors="replace")[-3000:]
                for r in range(nprocs))
            raise RuntimeError(f"workers exited {rcs}:\n{tail}")
        out = json.loads((workdir / "result.json").read_text())
        out["oneshot"] = (workdir / "oneshot").read_bytes()
        out["stream"] = (workdir / "stream").read_bytes()
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--workdir", type=pathlib.Path, required=True)
    ap.add_argument("--shard", action="append", required=True)
    ap.add_argument("--blocks-per-wave", type=int, default=None)
    ap.add_argument("--threads", type=int, default=1)
    a = ap.parse_args()
    worker(a.rank, a.port, a.nprocs, a.workdir, a.shard, a.blocks_per_wave,
           a.threads)
    return 0


if __name__ == "__main__":
    sys.exit(main())
