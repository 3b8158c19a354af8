"""One PyTorch CPU thread for the port's tests (tests/test_torch_*.py).

Tier-1 runs the suite in six worker processes on one machine, and the
port's tests run many small tensor operations; PyTorch's default pool of
one CPU thread per core in each worker oversubscribes the cores (the port's
files alone on six workers: 1,034 s of test time and 27.7 min of CPU with
the default pool, 925 s and 20.1 min with one thread).  Each port test
module imports the fixture, which sets one thread for the module and
restores the pool after it.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_cpu_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)
