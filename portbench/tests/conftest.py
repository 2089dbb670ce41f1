"""The benchmark's own tests: the references against the port on the CPU at
small sizes, the manifest and its files, and whole runs with the look for a
card skipped. Tests marked ``card`` run only where CUDA is present; each
decides that inside the test."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")
