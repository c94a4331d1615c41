"""A module fixture for the port's CPU test files: one intra-op thread.

These files run many small tensor ops, which intra-op threads only slow
down, most under a parallel run, where every worker's torch would
otherwise spread over all the host's cores.  A test file takes it with

    from _torch_threads import one_intra_op_thread  # noqa: F401

and the worker's own setting comes back after the module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
