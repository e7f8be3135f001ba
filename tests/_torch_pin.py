"""One intra-op thread for a test module's torch compute.

The suite runs several pytest-xdist workers on the same cores.  Each
worker's torch would start an intra-op thread for every core, and the
workers' busy-waiting pools then starve each other: small ops run tens of
times slower than on one thread.  A module pins itself by importing the
fixture, which is autouse and module-scoped and restores the count after
the module:

    from _torch_pin import one_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
