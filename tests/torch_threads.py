"""One intra-op thread for the port's CPU tests.

The suite runs in several pytest-xdist workers on one machine's cores. A
worker's default of one torch thread per core makes every worker's thread
pool contend for all of them, and the pools spin while they wait: under
six busy workers a test of ~5 s alone took 193 s. The port's CPU tests use
small tensors that gain little from sharing an op out, so each test file
imports this module's fixture, which holds torch at one thread for the
file's tests (the same as ``one_torch_thread`` in the fleet and traffic-lab
tests, which came first) and restores the count after them.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
