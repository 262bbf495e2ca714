"""The thread-count fixture shared by the port's heavier CPU test files.

A test module takes it with ``from torch_threads import two_threads  #
noqa: F401``: pytest finds the autouse fixture in the module's namespace.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """The scenes of these modules are small: two threads for the twins
    keep the six workers of a parallel test run from oversubscribing the
    cores (eight OpenMP threads each slowed a tick of the 1,331-node mesh
    from 0.2 s to over 10 s).  The process's thread count is restored after
    the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
