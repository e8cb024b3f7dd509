"""One intra-op thread for the port's CPU test modules.

Import the fixture into a test module (``from _torch_threads import
one_intra_op_thread  # noqa: F401``) and it applies to every test there:
the port's CPU paths are many small torch ops, and with several test
workers on one machine each worker's intra-op pool would spin against the
others'.  No check depends on the thread count.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
