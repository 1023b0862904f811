"""A fixture for the port's heavier CPU tests: one torch intra-op thread
while a module runs. The test runner puts several worker processes on the
CPU at once, and torch's threads in each of them otherwise spin against
each other (a 90 s set of tests then takes over 20 minutes)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
