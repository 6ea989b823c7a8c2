"""One CPU thread a test worker, a fixture that imports no JAX: the
modules that hold the port to the JAX package take it through
``_torch_port``, and those that hold it to references of its own import
it from here."""

import pytest
import torch
from threadpoolctl import threadpool_limits


@pytest.fixture(scope="module", autouse=True)
def single_cpu_thread():
    """One CPU thread for torch and the BLAS/OpenMP pools (JAX's LAPACK
    calls among them) while a module that imports this fixture runs. The
    test workers share the cores, and a pool of a thread a core then
    spins: a small dense solve or einsum ran 8-100x slower with every
    core busy. One thread a worker keeps them at their solo speed."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)
