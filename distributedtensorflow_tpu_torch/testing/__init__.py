"""Test harnesses of the port: ranks as threads of one process
(:func:`ranks.run_ranks`)."""

from .ranks import run_ranks  # noqa: F401
