"""Imported by every ``tests/test_torch_*.py``: under pytest-xdist, torch's
intra-op threads are capped to this worker's share of the machine's cores
while a port test file runs, so that the workers do not each start a pool
of every core. A file run alone keeps every thread.

xdist sets ``PYTEST_XDIST_WORKER_COUNT`` in each worker. The cap is
``max(1, os.cpu_count() // workers)``, taken when the module's tests start
(``capped_threads``, a module-scoped autouse fixture, so it holds for the
module's other fixtures too) and put back when they end. ``rank_env`` gives
the same cap to the rank processes a test spawns, through their
``OMP_NUM_THREADS``."""

import os
from typing import Optional

import pytest
import torch


def worker_threads() -> Optional[int]:
    """This xdist worker's share of the cores, or None outside xdist."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return None
    return max(1, (os.cpu_count() or 1) // int(workers))


def rank_env() -> Optional[dict]:
    """The environment for processes a test spawns: this process's, with
    ``OMP_NUM_THREADS`` set to the worker's share under xdist; None (the
    inherited environment) outside it."""
    n = worker_threads()
    if n is None:
        return None
    return {**os.environ, "OMP_NUM_THREADS": str(n)}


@pytest.fixture(scope="module", autouse=True)
def capped_threads():
    n = worker_threads()
    if n is None:
        yield None
        return
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    yield n
    torch.set_num_threads(before)
