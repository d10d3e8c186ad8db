"""The port's CPU test files import ``one_torch_thread`` from here, which
makes it an autouse fixture of each of their modules."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on
    one host, and a torch thread pool per process would oversubscribe it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
