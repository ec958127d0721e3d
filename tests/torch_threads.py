"""One intra-op thread for torch in the port's CPU tests.

The suite runs on several xdist workers at once.  At torch's default of one
intra-op thread per core, every worker's parallel regions wake a thread per
core, so the workers oversubscribe the cores many times over and small ops
wait on one another: on 6 workers over 8 cores the port's test files took
888 s, and 178 s with one thread a worker (the same 1,453 passes).  Each
``test_torch_*.py`` module imports the fixture below, which holds torch at
one thread while the module runs and gives the old count back after it.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
