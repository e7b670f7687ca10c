"""The benchmark's own tests (``python -m pytest portbench/tests`` from the
root of a checkout).  Tests that need a CUDA card carry the ``card`` marker
and decide inside the test whether one is present."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips inside the test without "
        "one")
