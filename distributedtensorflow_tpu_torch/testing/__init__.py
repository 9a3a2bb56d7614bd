"""Test harnesses of the port: ranks as threads of one process
(:func:`ranks.run_ranks`, :func:`ranks.run_mesh`,
:func:`ranks.run_group_ranks`), cluster tasks as
``spawn`` processes (:mod:`.multi_process_runner`: :func:`run`,
:class:`MultiProcessRunner`), and the intra-op thread count of a block
(:func:`threads.intra_op_threads`, and the module fixture
:func:`threads.two_intra_op_threads`)."""

from .multi_process_runner import (  # noqa: F401
    MultiProcessResult,
    MultiProcessRunner,
    SubprocessTimeoutError,
    UnexpectedSubprocessExitError,
    pick_unused_port,
    run,
)
from .ranks import run_group_ranks, run_mesh, run_ranks  # noqa: F401
from .threads import intra_op_threads, two_intra_op_threads  # noqa: F401
