"""The benchmark's own tests: ``python -m pytest tipbench/tests -q`` on the
CPU (the program runs its kernels' plain versions there); the tests marked
``card`` run only where a CUDA device is present, on the chip machine:
``python -m pytest tipbench/tests -q -m card``."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips itself without one)")
