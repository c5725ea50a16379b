"""Torch's CPU thread count for the port's tests.

The port's CPU path issues thousands of small torch ops. At torch's
default, each runs as a parallel region over every core, so pytest-xdist's
workers oversubscribe the machine and each small op waits on the others'
threads. Every `tests/test_torch_*.py` imports this module before the
port, so every worker (each collects every file) runs torch at THREADS
intra-op threads before its first test. OMP_NUM_THREADS, where unset,
carries the count to child interpreters. The JAX package's threads are
not touched.
"""

import os

import torch

THREADS = 2

os.environ.setdefault("OMP_NUM_THREADS", str(THREADS))
torch.set_num_threads(THREADS)
