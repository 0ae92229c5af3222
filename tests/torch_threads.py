"""A shared fixture of the port's tests (not a test file): torch on one
CPU thread while a test module runs.  The suite runs several worker
processes at once, where every process's own thread pool only
oversubscribes the cores.  A module takes it with

    from torch_threads import one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
