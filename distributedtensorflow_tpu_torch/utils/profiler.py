"""Tracing and profiling surface.

Twin of ``distributedtensorflow_tpu/utils/profiler.py`` (``:25-74``):
:func:`trace` captures a ``torch.profiler`` trace (host, and the card's
kernels where there is one) into a Chrome-trace file, :func:`annotate`
and :func:`named_scope` name a region on its timeline
(``record_function``, which labels the host range and the kernels it
launches alike), and :func:`save_device_memory_profile` dumps the CUDA
caching allocator's snapshot.  JAX's remote profiling server has no
``torch.profiler`` counterpart and is left out.
"""

from __future__ import annotations

import contextlib
import logging
import os
from collections.abc import Iterator

import torch

logger = logging.getLogger(__name__)

#: The Chrome-trace file :func:`trace` writes into its ``logdir``.
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the ``with`` body and write ``<logdir>/trace.json``
    (chrome://tracing, Perfetto); CUDA activity too where a card is."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = os.path.join(logdir, TRACE_FILE)
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


def annotate(name: str) -> contextlib.AbstractContextManager:
    """A named host range on the trace's timeline."""
    return torch.profiler.record_function(name)


def named_scope(name: str) -> contextlib.AbstractContextManager:
    """A named range that also labels the kernels launched inside it (the
    device-side scope of JAX's ``jax.named_scope``)."""
    return torch.profiler.record_function(name)


def save_device_memory_profile(path: str) -> None:
    """Dump the CUDA caching allocator's snapshot (segments, blocks, and
    the allocation history where ``torch.cuda.memory._record_memory_history``
    was on) to ``path``, a pickle that PyTorch's memory viewer reads."""
    torch.cuda.memory._dump_snapshot(path)
