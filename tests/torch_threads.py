"""The port's test files' one-thread fixture: torch on one intra-op thread
while a test module runs, since the suite runs one process a core
(``pytest -n``) and the ranks that ``run_ranks`` spawns pin their own.

A test file takes it with ``from torch_threads import one_torch_thread``:
an imported autouse fixture applies to the importing module alone."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
