"""CPU tests of the benchmark (python -m pytest portbench/tests). Tests
that need the card carry the `cuda` marker and skip without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ.setdefault("PLATANUS_B_TPU_TORCH_DEVICE", "cpu")


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA card (skips without one)")
