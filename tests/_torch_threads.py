"""Torch's CPU threads for the port's test modules.

pytest-xdist runs several workers on one machine, and each torch process
starts with a thread per core: six workers at eight threads each on eight
cores spend their time waiting for each other.  A port test module imports
`torch_threads`, a module-scoped autouse fixture that gives torch this
worker's share of the cores for the module and restores the previous count
after it.  Subprocesses get the same share through OMP_NUM_THREADS
(`worker_threads`).
"""
import os

import pytest
import torch


def worker_threads() -> int:
    """The cores divided among the pytest-xdist workers (all of them when
    pytest runs in one process)."""
    return max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(worker_threads())
    yield
    torch.set_num_threads(previous)
