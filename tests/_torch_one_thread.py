"""A module fixture for the port's CPU tests that run many small ops.

One intra-op thread runs them faster than several, and under the
parallel test run several spin against the other workers' threads (a
file of engine runs took 1175 s of test time with the default threads,
under 330 s with one).  A test module takes it with
``from _torch_one_thread import one_torch_thread  # noqa: F401``; the
setting is put back after the module.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
