"""One intra-op thread for torch while a test module runs.

The suite runs in several worker processes at once; torch's OpenMP
threads spin at each parallel region, so eight of them per worker
oversubscribe the cores and small ops slow down by two orders of
magnitude (a 4 s test took 350 s in a 6-worker run).  A test module
imports ``one_torch_thread`` to run its torch ops on one thread; the
previous count is restored after the module."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
