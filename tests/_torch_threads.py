"""The port's test modules that run many small eager torch ops (tiny CNNs
and LMs, their engines) import ``one_torch_thread``: an autouse,
module-scoped fixture that runs torch on one intra-op thread for the
module and restores the count after it.  Under the suite's parallel
workers torch's intra-op threads only contend for the cores."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
