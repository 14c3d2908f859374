"""Torch's intra-op threads in the port's test files under pytest-xdist.

Each xdist worker would otherwise start as many torch threads as the host
has cores, so six workers ask for six times the cores, beside XLA's own
threads, and the port's tests ran 10-40x their serial time. Under xdist
(PYTEST_XDIST_WORKER_COUNT set) each worker takes its share of the cores;
a run without workers keeps torch's default.
"""

import os

import torch


def share_cores() -> None:
    """Cap torch's intra-op threads at cores // workers under xdist."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(workers)))
