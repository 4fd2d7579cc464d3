"""One torch CPU thread per test module of the port.

The suite runs in six pytest-xdist workers on one machine, and torch's CPU
operations (OpenMP, MKL) start one thread per core in every worker; the
oversubscribed threads slowed the port's small products up to ~50x (a
poisson3d(12) solve on BandedBlocks levels: 15.8 s against 0.28 s on one
thread, beside six busy processes).  A test module imports
:func:`one_torch_thread`, an autouse fixture, to run its tests on one
thread; the count is restored when the module ends.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
