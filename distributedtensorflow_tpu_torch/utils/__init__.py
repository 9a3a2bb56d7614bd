"""Utilities of the port: metric writing, profiling, the watchdog and
determinism."""

from .determinism import derive_seed, enable_determinism, tree_fingerprint  # noqa: F401
from .metrics import MetricWriter, ThroughputMeter  # noqa: F401
from .profiler import (  # noqa: F401
    annotate,
    named_scope,
    save_device_memory_profile,
    start_trace,
    stop_trace,
    trace,
)
from .watchdog import Watchdog, dump_all_stacks  # noqa: F401
