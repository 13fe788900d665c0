"""One share of the cores for each process of a test run, set once.

The port's test files import this module. Every xdist worker imports every
test file while it collects them, so the share is in place before the
worker runs its first test, whichever tests it runs, and no test changes
it afterwards. The share, `THREADS`, is the cores over xdist's worker count
(`PYTEST_XDIST_WORKER_COUNT`, 1 without xdist), unless the caller set
OMP_NUM_THREADS: 1 thread a worker on 8 cores and 6 workers. It goes into
torch's intra-op pool and into OMP_NUM_THREADS / MKL_NUM_THREADS, which the
child processes the tests start inherit.

Without it each worker runs a torch pool the size of the machine: toy-size
steps then took a hundred times as long in a 6-worker run as alone (a
resume test 450 s against 13 s).
"""
import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", 1))
THREADS = int(os.environ.setdefault("OMP_NUM_THREADS",
                                    str(max(1, (os.cpu_count() or 1) // _WORKERS))))
os.environ.setdefault("MKL_NUM_THREADS", str(THREADS))
torch.set_num_threads(THREADS)
