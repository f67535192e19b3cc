"""The one-thread fixture of the port's CPU suites: a test module that
imports `one_torch_thread` runs each of its tests with PyTorch on one
intra-op thread."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test's PyTorch ops on one thread: the suite runs several test
    processes at once, and their intra-op thread pools would otherwise
    contend for the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
