"""One intra-op thread in each process that runs the port's tests.

Every tests/test_torch_*.py imports this module before it runs anything.
The suite runs in several pytest-xdist workers on one machine, each of
which would otherwise start one torch thread per core: the workers then
oversubscribe the cores, torch's waiting threads spin, and every test of
every worker slows many times over.  One thread each keeps the workers
from contending; the processes that tests/torch_dist_group.py starts set
the same."""

import torch

THREADS = 1

torch.set_num_threads(THREADS)
