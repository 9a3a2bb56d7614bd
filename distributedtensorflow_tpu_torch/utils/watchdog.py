"""Hang watchdog: dump every thread's stack when progress stalls.

Twin of ``distributedtensorflow_tpu/utils/watchdog.py`` (``:41-170``).
One wedged rank stalls every collective of the job, and the most useful
record of such a hang is where every thread was when it stalled.  The
watchdog exports ``watchdog_ping_age_seconds`` (gauge, refreshed every
poll: the ``/healthz`` liveness signal) and ``watchdog_timeouts_total``
(counter) into the ``obs`` registry, and on timeout appends a
``watchdog_timeout`` event (with the stack dump) to the flight recorder
and dumps its ring to ``flight.jsonl``.  The Trainer pings on dispatch:
the host returns from a step before the card ends it.

Usage::

    wd = Watchdog(timeout=300)   # starts armed
    for batch in data:
        step(...)
        wd.ping()                # progress heartbeat
    wd.stop()

or as a context manager around any region that may hang.
"""

from __future__ import annotations

import faulthandler
import logging
import os
import sys
import threading
import time
import traceback
from collections.abc import Callable

logger = logging.getLogger(__name__)


def dump_all_stacks(file=None) -> str:
    """Print the stack of every live thread (to stderr by default) and
    return the text."""
    out = []
    names = {t.ident: t.name for t in threading.enumerate()}
    for ident, frame in sys._current_frames().items():
        out.append(f"--- thread {names.get(ident, '?')} ({ident}) ---")
        out.extend(line.rstrip() for line in traceback.format_stack(frame))
    text = "\n".join(out)
    print(text, file=file or sys.stderr, flush=True)
    return text


class Watchdog:
    """Background timer that fires when :meth:`ping` stops arriving.

    On timeout it dumps every thread's stack and calls ``on_timeout``.
    The process keeps running unless ``fatal=True``, which aborts it after
    a ``faulthandler`` dump: what a job scheduler that restarts the task
    wants."""

    def __init__(self, timeout: float = 300.0, *,
                 on_timeout: Callable[[], None] | None = None,
                 fatal: bool = False, poll_interval: float | None = None,
                 flight_recorder=None):
        self.timeout = timeout
        self._on_timeout = on_timeout
        self._fatal = fatal
        #: Explicit flight recorder; None falls back to the process default
        #: at fire time (``obs.flight_recorder.install_recorder``).
        self._flight = flight_recorder
        self._last = time.monotonic()
        self._fired = False
        self._stop = threading.Event()
        self._poll = poll_interval if poll_interval is not None \
            else min(timeout / 4, 5.0)
        # imported here: obs imports utils, and utils imports this module
        from ..obs import registry  # noqa: PLC0415

        self._ping_age_gauge = registry.gauge(
            "watchdog_ping_age_seconds",
            "seconds since the last progress ping (refreshed every poll)")
        self._timeouts_counter = registry.counter(
            "watchdog_timeouts_total", "watchdog stall firings")
        self._ping_age_gauge.set(0.0)
        self._thread = threading.Thread(target=self._run, name="dtf-watchdog",
                                        daemon=True)
        self._thread.start()

    def ping(self) -> None:
        """Record progress; resets the timeout clock."""
        self._last = time.monotonic()
        self._fired = False
        self._ping_age_gauge.set(0.0)

    def ping_age(self) -> float:
        """Seconds since the last ping."""
        return time.monotonic() - self._last

    @property
    def fired(self) -> bool:
        return self._fired

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            idle = time.monotonic() - self._last
            self._ping_age_gauge.set(idle)
            if self._fired or idle < self.timeout:
                continue
            self._fired = True
            self._timeouts_counter.inc()
            logger.error("watchdog: no progress for %.0fs (timeout %.0fs); "
                         "dumping all thread stacks", idle, self.timeout)
            self._record_flight(idle, dump_all_stacks())
            if self._on_timeout is not None:
                try:
                    self._on_timeout()
                except Exception:
                    logger.exception("watchdog on_timeout callback failed")
            if self._fatal:
                faulthandler.dump_traceback()
                os.abort()

    def _record_flight(self, idle: float, stacks: str) -> None:
        """Append the stall to the flight ring and persist it."""
        from ..obs import flight_recorder  # noqa: PLC0415

        flight = self._flight or flight_recorder.default_recorder()
        if flight is None:
            return
        try:
            flight.record("watchdog_timeout", idle_s=round(idle, 3),
                          timeout_s=self.timeout, stacks=stacks)
            flight.dump(reason="watchdog_timeout")
        except Exception:
            logger.exception("watchdog flight-recorder dump failed")

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=self._poll * 2 + 1)

    def __enter__(self) -> "Watchdog":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
