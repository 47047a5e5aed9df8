"""The CPU thread budget of a port test process, set once, on import.

Every `test_torch_*` module imports this first. A process takes the CPUs
it may run on divided among pytest-xdist's workers (one worker outside
xdist), at least one thread: six workers at torch's default of a thread a
core would run six times as many threads as the machine has cores. The
budget goes to torch's intra-op pool and to `OMP_NUM_THREADS`, which the
CLI subprocesses inherit; `parallel.distributed.launch` divides it among
its CPU ranks.
"""

import contextlib
import os

import torch

THREADS = max(1, len(os.sched_getaffinity(0))
              // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
torch.set_num_threads(THREADS)
os.environ["OMP_NUM_THREADS"] = str(THREADS)


@contextlib.contextmanager
def threads(n: int):
    """This process at `n` intra-op threads inside (tests of the rule)."""
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(THREADS)
