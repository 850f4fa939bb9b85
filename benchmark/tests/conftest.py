"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
root of the repository. Tests marked ``card`` need an NVIDIA card and skip
without one (decided inside each test)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")
