"""The intra-op thread count of the process, set for a block.

The CPU tests run as several pytest workers on one box; PyTorch's
default of one intra-op thread a core in every worker oversubscribes the
cores many times over, and the workers' spinning thread pools then slow
each other down.  A test module runs its tests inside
:func:`intra_op_threads` of a few threads (the fixture
:func:`two_intra_op_threads`, which a module imports by name); the count
goes back to what it was after the block.
"""

from __future__ import annotations

import contextlib

import pytest
import torch


@contextlib.contextmanager
def intra_op_threads(n: int):
    """``torch.set_num_threads(n)`` inside the block, the previous count
    after it."""
    previous = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(previous)


@pytest.fixture(scope="module", autouse=True)
def two_intra_op_threads():
    """Two intra-op threads for the tests of the module that imports this
    fixture: the suite's workers share the box's cores, which a thread a
    core in each oversubscribes."""
    with intra_op_threads(2):
        yield
