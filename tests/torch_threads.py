"""Torch's CPU threads for the port's tests, numpy-free and JAX-free.

Under pytest-xdist each worker is a process of its own, and torch starts
one intra-op thread per core in every one of them: six workers on eight
cores run some 48 compute threads, which spend their time waiting on one
another. Each ``tests/test_torch_*.py`` imports this module, which gives
a worker ``cores // workers`` threads (at least one); a run without
workers keeps torch's default.
"""

import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
if WORKERS > 1:
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // WORKERS))
