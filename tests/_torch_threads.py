"""The port's test modules' one-thread fixture: import ``one_thread`` into
a module to run its tests on one torch thread."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Smoke-width engines and ops issue many tiny ops, which torch's
    intra-op threads only slow down (and, beside the other test workers,
    oversubscribe the cores): one thread for the importing module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
