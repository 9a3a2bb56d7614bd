"""Tracing and profiling surface.

Twin of ``distributedtensorflow_tpu/utils/profiler.py`` (``:25-74``):
:func:`trace` (and the process-wide session of :func:`start_trace` and
:func:`stop_trace`, which the reactive profiler ``obs.capture`` drives)
captures a ``torch.profiler`` trace (host, and the card's kernels where
there is one) into a Chrome-trace file, :func:`annotate`
and :func:`named_scope` name a region on its timeline
(``record_function``, which labels the host range and the kernels it
launches alike), and :func:`save_device_memory_profile` dumps the CUDA
caching allocator's snapshot.  :func:`start_server` is the remote
capture server: JAX's is a ``jax.profiler`` server that TensorBoard pulls
XPlane traces from, which ``torch.profiler`` has no counterpart of; the
port's serves the capture engine's ``/profilez`` over HTTP (``POST
/profilez?steps=N`` arms a capture of the next N steps, ``GET`` its
state), so no TensorBoard client can pull from it.
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


#: The profiler session :func:`start_trace` opened, and its directory.
_session: tuple[torch.profiler.profile, str] | None = None
#: Spin kernels (``torch.cuda._sleep``, ``SPIN_CYCLES`` each) launched and
#: waited for when a session opens on a card.  On the H100 the sessions
#: lost the device records of the first launches after they started (7 to
#: 26 launches, the first 0.3 ms of them, their host-side launch records
#: kept): the burst takes that loss in place of the profiled work.
WARMUP_LAUNCHES = 128
SPIN_CYCLES = 20_000


def start_trace(logdir: str) -> None:
    """Start a process-wide ``torch.profiler`` session writing into
    ``logdir`` at :func:`stop_trace` (the twin of
    ``jax.profiler.start_trace``): CPU activity, and CUDA activity where a
    card is.  The session opens on an idle card (a synchronize first), so
    that it holds the kernels of the work launched inside it and none that
    the host queued before, and :func:`stop_trace` closes it on an idle
    card; it opens with :data:`WARMUP_LAUNCHES` spin kernels.  Raises if a
    session is open already."""
    global _session
    if _session is not None:
        raise RuntimeError(f"a profiler session is open already "
                           f"(writing to {_session[1]})")
    activities = [torch.profiler.ProfilerActivity.CPU]
    card = torch.cuda.is_available() and torch.cuda.is_initialized()
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    if card:
        torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    if card:
        for _ in range(WARMUP_LAUNCHES):
            torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
    _session = (prof, logdir)


def stop_trace() -> torch.profiler.profile:
    """Stop the session of :func:`start_trace`, write its
    ``<logdir>/trace.json`` and return the profile."""
    global _session
    if _session is None:
        raise RuntimeError("no profiler session is open")
    (prof, logdir), _session = _session, None
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    prof.stop()
    path = os.path.join(logdir, TRACE_FILE)
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)
    return prof


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the ``with`` body and write ``<logdir>/trace.json``
    (chrome://tracing, Perfetto); CUDA activity too where a card is."""
    start_trace(logdir)
    prof = _session[0]
    try:
        yield prof
    finally:
        stop_trace()


def start_server(port: int, host: str = "127.0.0.1"):
    """Start the on-demand capture server on ``port`` (0: an ephemeral
    one) and return it (``.port``, ``.stop()``): an ``obs.StatusServer``
    whose ``/profilez`` arms and reads the process's capture engine
    (``obs.capture.default_engine()``, the Trainer's), with the handlers
    of the status server's own ``/profilez``.  A capture lands in
    ``<logdir>/captures/<id>/`` with its row in ``captures.jsonl``."""
    from ..obs.server import StatusServer  # noqa: PLC0415

    server = StatusServer(port, host=host).start()
    logger.info("profiler server listening on port %d", server.port)
    return server


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
