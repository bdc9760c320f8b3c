"""Size torch's CPU thread pool to this test process's share of the cores.

torch starts one OpenMP thread a core in every process. Under pytest-xdist
(``-n 6``) each worker would do so, and the workers' pools together
oversubscribe the machine: their threads spin for each other's cores, and a
CLI rehearsal that takes 1.6 s alone took 263 s in the suite. Each port test
module imports this first, so that a worker's pool holds its share of the
cores (one thread at six workers on eight cores); a run without xdist keeps
every core.
"""

import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))
