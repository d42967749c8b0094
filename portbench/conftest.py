"""pytest settings of the benchmark's own tests: the package under test on
the path, and the one marker of the tests that need the card."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: runs on an NVIDIA card; skips where there is none")
