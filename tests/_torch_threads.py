"""torch's intra-op threads capped to a worker's share of the cores.

Under pytest-xdist every worker process starts a torch thread pool as wide
as the machine, so n workers run n times as many threads as there are
cores, and a test that takes a fraction of a second alone can take
minutes among them. A port test file takes the cap with one line::

    import _torch_threads  # noqa: F401

Under xdist (``PYTEST_XDIST_WORKER_COUNT`` set) it gives this process
``cores // workers`` threads (at least one) and sets ``OMP_NUM_THREADS``
to the same width unless it is set already, so the processes a test
spawns (the distributed, fleet and elastic workers) start with the same
width: a CPU GEMM's bits can depend on its thread count, and the
bitwise checks between such a child and the test's own process need the
two to agree. Without xdist it changes nothing.
"""
import os

import torch


def _width() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
    if workers < 1:
        return 0
    return max(1, len(os.sched_getaffinity(0)) // workers)


WIDTH = _width()
if WIDTH:
    torch.set_num_threads(WIDTH)
    os.environ.setdefault("OMP_NUM_THREADS", str(WIDTH))
