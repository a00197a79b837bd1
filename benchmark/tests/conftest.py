"""The benchmark's own CPU tests: ``python -m pytest benchmark/tests -q``.

Tests that need the card carry the ``cuda`` marker and skip here; whether a
card is present is decided inside each test, never at import.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")
