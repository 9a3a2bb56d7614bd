"""Crash/hang flight recorder: a bounded ring of structured events.

Twin of ``distributedtensorflow_tpu/obs/flight_recorder.py``,
framework-free and copied whole but for the list of event kinds below.

Post-hoc telemetry (``metrics.jsonl``, ``trace.jsonl``) explains a run
that *finished*; the dominant failure mode at scale is a job that is
wedged (one rank stalls a collective) or dying (device-memory
exhaustion, NaN cascade) — where the most valuable artifact is "what was
the process doing in its last minutes". The flight recorder is that
artifact: every instrumented layer appends small structured events (step
boundaries, checkpoint begin/end, anomalies, preemption signals,
coordinator dispatch phases) into an in-memory ring, and the ring is
dumped to ``flight.jsonl`` whenever the process looks like it is going
down:

- watchdog timeout (``utils.watchdog.Watchdog`` routes its stall dump here);
- unhandled exception (:meth:`FlightRecorder.install_crash_hooks` chains
  ``sys.excepthook`` / ``threading.excepthook``);
- detected anomaly (the Trainer's ``on_anomaly`` sink calls
  :meth:`record_anomaly`);
- preemption signal (``checkpoint.PreemptionHandler``);
- clean fit exit (so a healthy run leaves a record too).

``flight.jsonl`` event schema (one JSON object per line, ring order —
oldest first, newest last)::

    {"t": float unix seconds, "kind": str, "step": int?, ...}

``t`` and ``kind`` are always present; ``step`` when the event is anchored
to an optimizer step; every other field is event-specific (strict JSON —
non-finite numbers become the writer's ``"NaN"``/``"Infinity"`` sentinel
strings).  Kinds the port emits: ``step``, ``log``, ``eval``,
``checkpoint_begin``, ``checkpoint_end``, ``checkpoint_corrupt`` (a
restore rejected a truncated or corrupt step and fell back —
``checkpoint.manager``), ``anomaly``, ``preemption``,
``preemption_save``, ``watchdog_timeout``, ``exception``,
``compile_begin``/``compile`` (the first dispatch of a step: kernel
loads, cuBLAS start-up; a ring ending in ``compile_begin`` with no
matching ``compile`` = wedged in the first dispatch, not a collective),
``capture_begin``/``capture_end`` (reactive-profiler windows —
``obs.capture``), ``goodput``, ``slo_violation`` (an SLO burn-rate
threshold trip — ``obs.slo``), ``alert`` (an alert rule fired or
resolved — ``obs.alerts``), ``nan_provenance`` (the first module to
produce a non-finite value, named by the NaN-provenance pass —
``obs.dynamics``), ``fit_begin``, ``fit_end``.

The hot path is one ``time.time()`` + one deque append under a lock; dumps
rewrite the whole file atomically (tmp + rename) so a reader — or the
``/flightz`` endpoint — never sees a torn record.

Module-level convenience: :func:`install_recorder` makes one recorder the
process default; :func:`record_event` appends to it (a no-op when none is
installed), which is how deep layers (engine, checkpoint manager,
preemption, watchdog) emit markers without plumbing a recorder handle.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import sys
import threading
import time
from typing import Any

from . import goodput

logger = logging.getLogger(__name__)

__all__ = [
    "FlightRecorder",
    "default_recorder",
    "install_recorder",
    "record_event",
]

#: Default ring capacity — at one event per dispatch plus markers, several
#: minutes of history even at sub-second step times.
DEFAULT_CAPACITY = 2048


class FlightRecorder:
    """Bounded in-memory ring of structured events, dumpable to jsonl.

    ``path=None`` keeps the recorder accounting-only (events are still
    served live via :meth:`events` / the ``/flightz`` endpoint); with a
    path, :meth:`dump` (and every crash-shaped trigger) rewrites the file
    with the current ring.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 path: str | None = None):
        self._events: collections.deque[dict[str, Any]] = collections.deque(
            maxlen=max(1, int(capacity))
        )
        self._lock = threading.Lock()
        self.path = path
        self._prev_excepthook = None
        self._prev_threading_hook = None

    # -- intake --------------------------------------------------------------

    def record(self, kind: str, *, step: int | None = None,
               **fields: Any) -> dict[str, Any]:
        """Append one event; returns it (mutating the return has no effect
        on the ring copy already stored)."""
        event: dict[str, Any] = {"t": 0.0, "kind": str(kind)}
        if step is not None:
            event["step"] = int(step)
        event.update(fields)
        with self._lock:
            # Stamp UNDER the lock: a timestamp taken outside could be
            # appended after a later one from another thread, and the
            # schema gate treats a decreasing ``t`` as corruption.
            event["t"] = time.time()
            self._events.append(event)
        # Goodput tap (outside the ring lock — the ledger has its own):
        # event kinds drive the ledger's preemption-drain stamp and its
        # per-generation event counts.  `goodput` events originate there.
        goodput.note_event(event["kind"])
        return event

    def record_anomaly(self, anomaly) -> None:
        """Sink for ``AnomalyDetector``/``Callback.on_anomaly``: record the
        anomaly as an event AND dump — a detected anomaly is exactly the
        moment the last-minutes record becomes worth persisting."""
        self.record(
            "anomaly", step=anomaly.step, anomaly=anomaly.kind,
            message=anomaly.message, value=float(anomaly.value),
        )
        self.dump(reason=f"anomaly:{anomaly.kind}")

    # -- read ----------------------------------------------------------------

    def events(self) -> list[dict[str, Any]]:
        """Snapshot of the ring, oldest first."""
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    # -- dump ----------------------------------------------------------------

    def dump(self, path: str | None = None, *,
             reason: str | None = None) -> str | None:
        """Write the ring to ``path`` (default: the constructor's) as jsonl.

        Atomic (tmp + rename): repeated dumps — anomaly, then watchdog,
        then the crash hook — each leave a complete, parseable file whose
        last line is the newest event.  Returns the path written, or None
        when the recorder has no path (accounting-only).  Never raises: a
        full disk must not turn a forensic dump into the fatal error.
        """
        path = path or self.path
        if path is None:
            return None
        from ..utils.metrics import json_sanitize  # noqa: PLC0415

        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                for event in self.events():
                    try:
                        line = json.dumps(json_sanitize(event),
                                          allow_nan=False)
                    except (TypeError, ValueError):
                        # A non-JSON field (numpy scalar, object) must
                        # not cost the whole forensic record — degrade
                        # that event to its repr.
                        line = json.dumps({
                            "t": event.get("t"),
                            "kind": event.get("kind", "?"),
                            "unserializable": repr(event)[:500],
                        })
                    f.write(line + "\n")
            os.replace(tmp, path)
        except Exception:  # full disk etc. — a dump is never the fatal error
            logger.exception("flight recorder dump to %s failed", path)
            return None
        if reason:
            logger.warning("flight recorder dumped to %s (%s)", path, reason)
        return path

    # -- crash hooks ---------------------------------------------------------

    def install_crash_hooks(self) -> None:
        """Chain ``sys.excepthook`` / ``threading.excepthook`` so an
        unhandled exception records an ``exception`` event and dumps the
        ring before the previous hook (usually the default traceback
        printer) runs.  Idempotent."""
        if self._prev_excepthook is not None:
            return
        self._prev_excepthook = sys.excepthook

        def _hook(exc_type, exc, tb):
            self.record(
                "exception", exc_type=exc_type.__name__,
                message=str(exc)[:500],
            )
            self.dump(reason=f"unhandled {exc_type.__name__}")
            self._prev_excepthook(exc_type, exc, tb)

        sys.excepthook = _hook
        self._prev_threading_hook = threading.excepthook

        def _thread_hook(args):
            if args.exc_type is not SystemExit:
                self.record(
                    "exception", exc_type=args.exc_type.__name__,
                    message=str(args.exc_value)[:500],
                    thread=getattr(args.thread, "name", "?"),
                )
                self.dump(reason=f"thread {args.exc_type.__name__}")
            self._prev_threading_hook(args)

        threading.excepthook = _thread_hook

    def uninstall_crash_hooks(self) -> None:
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None
        if self._prev_threading_hook is not None:
            threading.excepthook = self._prev_threading_hook
            self._prev_threading_hook = None


_default: FlightRecorder | None = None
_default_lock = threading.Lock()


def default_recorder() -> FlightRecorder | None:
    """The process-default recorder, or None when none is installed."""
    return _default


def install_recorder(rec: FlightRecorder | None) -> FlightRecorder | None:
    """Install ``rec`` as the process default (None uninstalls); returns
    the previous one.  Deep layers emit through :func:`record_event`, so
    installing is what turns their markers on."""
    global _default
    with _default_lock:
        prev, _default = _default, rec
    return prev


def record_event(kind: str, *, step: int | None = None, **fields) -> None:
    """Append to the default recorder; no-op (one attribute read) when no
    recorder is installed — safe on any hot-ish path."""
    rec = _default
    if rec is not None:
        rec.record(kind, step=step, **fields)
