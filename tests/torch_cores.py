"""One share of the host's cores for each pytest-xdist worker, for the
port's tests; not a test module. Torch runs its intra-op pool on every core
by default, so six workers on an eight-core host run 48 OpenMP threads that
spin against each other: the port's six slowest test files took 1888 s of
summed test time with torch's default there and 533 s with one thread a
worker (``-n 6``, 8 cores). The port's test helpers import this module, and
a worker collects every test module before it runs any, so the share holds
for the whole run; a run without xdist keeps torch's default."""

import os

import torch


def share_cores() -> None:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if workers > 1:
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // workers))


share_cores()
