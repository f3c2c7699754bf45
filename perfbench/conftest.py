"""The benchmark's CPU tests run torch on one thread: the driver runs the
suite in several processes at once, and a threaded BLAS in each would
oversubscribe the cores and stretch the small runs' windows."""

import pytest
import torch


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
