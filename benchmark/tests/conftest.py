"""The benchmark's own tests: on the CPU at tiny widths, and (marker
``cuda``) on the card at the cells' own sizes:

    python -m pytest benchmark/tests -q -p no:cacheprovider
    python -m pytest benchmark/tests -q -p no:cacheprovider -m cuda

Nothing here imports jax or the JAX package."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")
