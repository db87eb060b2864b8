"""pytest settings of the benchmark's own tests (``python -m pytest
portbench/tests``). Tests that need the card carry the ``card`` marker and
decide inside a fixture whether there is one."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: runs the benchmark on an NVIDIA card; skipped "
        "where torch sees none")
