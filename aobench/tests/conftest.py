"""Settings of the benchmark's own tests (``python -m pytest
aobench/tests``): the card marker, the repository root on the path, and
under pytest-xdist a share of the cores for each worker's CPU threads
(the plain versions run many small ops, which slow by tens of times when
every worker starts a thread a core)."""

import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (tpuao_torch's kernels); skips without one")
    workers = getattr(config, "workerinput", {}).get("workercount")
    if workers:
        import torch

        torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(workers)))
