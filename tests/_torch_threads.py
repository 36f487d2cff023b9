"""Caps torch's intra-op threads at this process's share of the cores.

The suite runs as several pytest-xdist workers on one machine. Each worker
runs the port's in-process tests on torch's default of one thread a core,
so six workers spin six times as many OpenMP threads as there are cores;
a test that takes seconds alone then takes minutes. Every
``tests/test_torch_*.py`` imports this module first: the first import in a
process sets the cap, once, and a file run alone gets it too. Child
processes set ``OMP_NUM_THREADS=1`` themselves.
"""

import os

import torch

THREADS = max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
torch.set_num_threads(THREADS)
