"""Test harnesses of the port: ranks as threads of one process
(:func:`ranks.run_ranks`, :func:`ranks.run_mesh`) and the intra-op thread
count of a block (:func:`threads.intra_op_threads`, and the module
fixture :func:`threads.two_intra_op_threads`)."""

from .ranks import run_mesh, run_ranks  # noqa: F401
from .threads import intra_op_threads, two_intra_op_threads  # noqa: F401
