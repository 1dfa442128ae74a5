"""One PyTorch intra-op thread while a port test module runs.

The suite runs in several worker processes on one machine.  The port's
many small eager ops (fits, LM steps, window sums) slow down by an order
of magnitude when every worker's intra-op thread pool oversubscribes the
cores, and their spinning threads slow the other workers too.  A test
module imports the fixture to use it::

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
