"""The port's test modules run torch on one intra-op thread.

Their tests run many small torch ops, and under the suite's parallel workers
torch's default of one thread a core only makes the threads contend: with six
workers on an 8-core host the port's files ran 17% slower in all (4405 s of
test time against 3663 s on one thread). A module takes the fixture by
importing it."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
