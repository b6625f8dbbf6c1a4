"""Settings of the benchmark's own tests (``python -m pytest
aobench/tests``): the card marker, and the repository root on the path."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (tpuao_torch's kernels); skips without one")
