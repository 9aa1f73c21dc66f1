"""One torch intra-op thread in the port's CPU tests.

Imported by each `tests/test_torch_*.py` file (`from torch_threads import
one_torch_thread`), whose module it then covers: the tier-1 run puts six
pytest workers on the machine's cores, and torch's default of a thread a
core in each of them made the port's CPU trainer runs contend for the
cores, 57x slower than alone. The port's tests compare runs within one
process bit for bit, or against the JAX package within a tolerance, so the
thread count changes no result.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
