"""Reactive profiling: the CaptureEngine owns every profiler window.

Twin of ``distributedtensorflow_tpu/obs/capture.py``: the same engine,
triggers, budget, cooldown and manifest, with ``torch.profiler`` in place
of ``jax.profiler``.  A window opens a ``torch.profiler.profile`` with
CPU and, where there is a card, CUDA activities
(:func:`..utils.profiler.start_trace`) and closes it into a Chrome trace,
``<capture dir>/trace.json`` (:func:`..utils.profiler.stop_trace`).

The passive telemetry stack (metrics, spans, flight ring, goodput) tells
you *that* something went wrong; the evidence that explains *why* — a
device trace of the slow steps — used to require a preconfigured window
(``--profile-dir`` + ``--profile-start``) that is almost never armed when
the interesting thing happens.  This module closes the loop: the moment
the anomaly detector or the cross-rank straggler aggregation says
something is wrong, the engine captures a bounded profiler window of
exactly those steps.

One engine per Trainer owns all three capture paths (one code path, one
artifact discipline):

- **triggered** — armed by ``AnomalyDetector`` step-time regressions and
  by cross-host spread blowups (``aggregate.spread_ratio``) when
  ``TrainerConfig.auto_profile`` is on; bounded by a per-run budget
  (``max_captures``) and a cooldown between captures;
- **on-demand** — ``POST /profilez?steps=N`` on the ``StatusServer`` arms
  a capture of the next N steps, so a live run can be profiled without
  restarting (budget-bounded, cooldown-exempt — a human asked);
- **static** — the classic ``--profile-dir`` window, routed through the
  same engine (budget- and cooldown-exempt: it was explicitly
  configured), opening at ``at_step`` exactly like the old inline code.

Every capture writes a ``captures/<id>/`` profile dir (Chrome trace) plus
one manifest row in ``<logdir>/captures.jsonl``::

    {"id": 0, "trigger": "step_time_regression", "reason": "...",
     "step_begin": 17, "step_end": 22, "t_begin": ..., "t_end": ...,
     "wall_s": 0.53, "overhead_s": 0.12, "dir": "captures/0"}

(``aborted: true`` when the fit ended before the window closed; ids are
monotonic; ``trigger`` is one of :data:`TRIGGERS`).  Each capture also
emits ``capture_begin``/``capture_end`` flight events, books its
start/stop overhead into the goodput ``profile_capture`` bucket (the
``profile_capture`` spans around the profiler calls feed the ledger's
span sink — the *profiled* steps themselves still book as
``train_step``: they ran), and bumps
``profiler_captures_total{trigger=...}``.

Threading: ``request`` may be called from any thread (the StatusServer
handler); ``maybe_start``/``maybe_stop``/``abort`` run on the fit-loop
thread only.  The profiler is process-global, so at most one capture is
active at a time; one immediate (triggered/manual) request and one
step-gated (static ``at_step``) request can be armed side by side — a
static window scheduled for a far-future step must not lock reactive
profiling out in the meantime — and further requests are refused until
their slot frees.  Profiler start/stop calls run outside the engine
lock, so ``state()`` (and ``/profilez``/``/statusz``) keep answering
even if the profiler wedges.

``capture_active()`` is a module-global fast flag (one attribute read)
for hot-ish paths that want to decorate the trace only while a window is
open.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Callable

from ..parallel import bootstrap
from ..utils import profiler
from . import tracing
from .flight_recorder import record_event
from .registry import counter

logger = logging.getLogger(__name__)

__all__ = [
    "TRIGGERS",
    "CaptureEngine",
    "capture_active",
    "default_engine",
    "install_engine",
]

#: The known capture trigger kinds (the ``captures.jsonl`` schema —
#: ``tools/check_metrics_schema.py`` validates against this set).
TRIGGERS = ("static", "manual", "step_time_regression", "straggler_spread",
            "slo_burn", "alert")

_M_CAPTURES = counter(
    "profiler_captures_total", "profiler captures started, by trigger"
)

#: Module-global "a capture window is open" flag; read lock-free.
_active_flag = False


def capture_active() -> bool:
    """True while a profiler capture window is open (one attribute read)."""
    return _active_flag


def _default_start(logdir: str) -> None:
    profiler.start_trace(logdir)


def _default_stop() -> None:
    profiler.stop_trace()


class CaptureEngine:
    """Owns the process's profiler windows: arm → start → stop → manifest.

    ``logdir=None`` disables the default capture root (a request must then
    supply an explicit ``dir``, e.g. the static ``--profile-dir`` window);
    with a logdir, capture ``<id>`` lands in ``<logdir>/captures/<id>/``
    and the manifest at ``<logdir>/captures.jsonl`` (chief process only —
    the MetricWriter convention; every process writes its own trace, so
    the ranks of one host need logdirs of their own).

    ``profiler_start``/``profiler_stop`` are injectable for tests (the
    real profiler is process-global and slow to exercise).
    """

    def __init__(
        self,
        logdir: str | None = None,
        *,
        max_captures: int = 8,
        cooldown_s: float = 120.0,
        window_steps: int = 5,
        max_window_steps: int = 512,
        chief_only: bool = True,
        time_fn: Callable[[], float] = time.time,
        profiler_start: Callable[[str], None] = _default_start,
        profiler_stop: Callable[[], None] = _default_stop,
    ):
        self.root = os.path.join(logdir, "captures") if logdir else None
        self.manifest_path = (
            os.path.join(logdir, "captures.jsonl") if logdir else None
        )
        self.max_captures = max(0, int(max_captures))
        self.cooldown_s = float(cooldown_s)
        self.window_steps = max(1, int(window_steps))
        self.max_window_steps = max(1, int(max_window_steps))
        self._time = time_fn
        self._start = profiler_start
        self._stop = profiler_stop
        # Chiefness resolved lazily at the first manifest write (the same
        # reason as GoodputLedger: the engine may exist before the process
        # group does).
        self._chief_pending = chief_only and self.manifest_path is not None
        self._lock = threading.Lock()
        #: Immediate-start request (triggered/manual): opens at the next
        #: step boundary.  A SEPARATE slot from `_scheduled` so a static
        #: window armed for a far-future step never blocks reactive or
        #: on-demand captures in the meantime.
        self._armed: dict[str, Any] | None = None
        #: Step-gated request (the static ``at_step`` window).
        self._scheduled: dict[str, Any] | None = None
        self._active: dict[str, Any] | None = None
        self._starting = False  # profiler start in flight (outside the lock)
        self._next_id = 0
        self._used = 0  # budget-counted (triggered + manual) captures
        self._last_end_t: float | None = None
        #: Completed manifest rows, oldest first (the /profilez state).
        self.rows: list[dict[str, Any]] = []

    # -- arming (any thread) -------------------------------------------------

    def request(
        self,
        trigger: str,
        *,
        steps: int | None = None,
        reason: str = "",
        dir: str | None = None,
        at_step: int | None = None,
        budget: bool = True,
        cooldown: bool = True,
    ) -> tuple[bool, str]:
        """Arm a capture of the next ``steps`` optimizer steps (or the
        window opening at ``at_step`` — the static path).  Returns
        ``(accepted, why)``; never raises.

        ``budget=False`` / ``cooldown=False`` exempt the request from the
        per-run cap / the between-captures cooldown (the static window is
        exempt from both; ``/profilez`` manual requests skip the cooldown
        but still count against the budget).
        """
        if trigger not in TRIGGERS:
            return False, f"unknown trigger {trigger!r}"
        steps = int(steps) if steps else self.window_steps
        if steps < 1:
            return False, f"steps must be >= 1, got {steps}"
        steps = min(steps, self.max_window_steps)
        refused = None
        with self._lock:
            slot_scheduled = at_step is not None
            if self._active is not None or self._starting:
                refused = "a capture is already active"
            elif slot_scheduled and self._scheduled is not None:
                refused = (
                    f"a step-gated capture is already armed "
                    f"({self._scheduled['trigger']} at step "
                    f"{self._scheduled['at_step']})"
                )
            elif not slot_scheduled and self._armed is not None:
                refused = (
                    f"a capture is already armed "
                    f"({self._armed['trigger']})"
                )
            elif budget and self._used >= self.max_captures:
                refused = (
                    f"capture budget exhausted "
                    f"({self._used}/{self.max_captures})"
                )
            elif cooldown and self._last_end_t is not None \
                    and (self._time() - self._last_end_t) < self.cooldown_s:
                age = self._time() - self._last_end_t
                refused = (
                    f"in cooldown ({age:.0f}s of {self.cooldown_s:.0f}s "
                    "since the last capture)"
                )
            elif dir is None and self.root is None:
                refused = "no capture directory (engine has no logdir)"
            else:
                if budget:
                    self._used += 1
                req = {
                    "trigger": trigger,
                    "reason": str(reason)[:500],
                    "steps": steps,
                    "dir": dir,
                    "at_step": at_step,
                    "budget": budget,
                }
                if slot_scheduled:
                    self._scheduled = req
                else:
                    self._armed = req
        if refused is not None:
            logger.info(
                "capture request refused (trigger=%s): %s", trigger, refused
            )
            return False, refused
        logger.info(
            "capture armed: trigger=%s steps=%d%s%s", trigger, steps,
            f" at_step={at_step}" if at_step is not None else "",
            f" ({reason})" if reason else "",
        )
        return True, "armed"

    # -- fit-loop hooks (one thread) -----------------------------------------

    def maybe_start(self, step: int, k: int = 1) -> bool:
        """Open an armed window if its time has come.  Called at the top
        of every fit-loop iteration, BEFORE the host batch fetch (the
        profile must capture input-pipeline time); ``step`` is the
        completed-step count, ``k`` the steps this dispatch will run.
        Near-free when nothing is armed (two attribute reads).

        The profiler start itself runs OUTSIDE the engine lock: ``state()``
        (and through it ``/profilez`` and ``/statusz``) must keep
        answering even if ``start_trace`` wedges — that is the exact
        scenario the introspection surface exists for.
        """
        if self._armed is None and self._scheduled is None:
            return False
        global _active_flag
        with self._lock:
            if self._active is not None or self._starting:
                return False
            req = None
            sched = self._scheduled
            if sched is not None:
                at = sched["at_step"]
                if step <= at < step + max(k, 1):
                    req, self._scheduled = sched, None
            if req is None:
                req, self._armed = self._armed, None
            if req is None:
                return False
            cap_id = self._next_id
            self._next_id += 1
            cap_dir = req["dir"] or os.path.join(self.root, str(cap_id))
            at = req["at_step"]
            step_begin = at if at is not None else step
            self._starting = True  # holds the slot while the lock is free
        try:
            os.makedirs(cap_dir, exist_ok=True)
            t0 = time.perf_counter()
            # The span books the start/stop overhead into the goodput
            # `profile_capture` bucket via the tracer's root sink.
            with tracing.span("profile_capture"):
                self._start(cap_dir)
            overhead = time.perf_counter() - t0
        except Exception:
            # A profiler that refuses to start (already tracing via
            # another path, unwritable dir) must never kill the fit — and
            # must not burn the budget: a run whose starts all fail would
            # otherwise exhaust max_captures with zero artifacts.
            logger.exception(
                "capture %d (%s) failed to start in %s",
                cap_id, req["trigger"], cap_dir,
            )
            with self._lock:
                self._starting = False
                if req["budget"]:
                    self._used -= 1
            return False
        with self._lock:
            self._starting = False
            self._active = {
                "id": cap_id,
                "trigger": req["trigger"],
                "reason": req["reason"],
                "dir": cap_dir,
                "step_begin": int(step_begin),
                "end_step": int(step_begin) + req["steps"],
                "t_begin": self._time(),
                "overhead_s": overhead,
            }
            _active_flag = True
        _M_CAPTURES.inc(trigger=req["trigger"])
        record_event(
            "capture_begin", step=int(step_begin), id=cap_id,
            trigger=req["trigger"], dir=self._rel(cap_dir),
        )
        logger.info(
            "capture %d (%s) started at step %d -> %s",
            cap_id, req["trigger"], step_begin, cap_dir,
        )
        return True

    def maybe_stop(
        self,
        step: int,
        *,
        fetch: Callable[[], Any] | None = None,
        force: bool = False,
    ) -> dict[str, Any] | None:
        """Close the active window once ``step`` reaches its end (or
        unconditionally with ``force`` — the abort path).  ``fetch`` is
        called before the stop so the profiled dispatches actually execute
        (the async-dispatch flush); returns the manifest row written, or
        None when nothing closed."""
        act = self._active
        if act is None:
            return None
        if not force and step < act["end_step"]:
            return None
        global _active_flag
        if fetch is not None:
            try:
                fetch()
            except Exception:
                logger.exception("capture %d: metric flush failed", act["id"])
        t0 = time.perf_counter()
        try:
            with tracing.span("profile_capture"):
                self._stop()
        except Exception:
            logger.exception("capture %d failed to stop", act["id"])
        overhead = act["overhead_s"] + (time.perf_counter() - t0)
        now = self._time()
        with self._lock:
            self._active = None
            _active_flag = False
            self._last_end_t = now
            # Clamp: an abort can be handed a step BELOW step_begin (the
            # window opened for a dispatch that then raised, so the step
            # count never advanced past it) — the manifest schema requires
            # step_end >= step_begin.
            step_end = max(int(step), act["step_begin"])
            row: dict[str, Any] = {
                "id": act["id"],
                "trigger": act["trigger"],
                "reason": act["reason"],
                "step_begin": act["step_begin"],
                "step_end": step_end,
                "t_begin": act["t_begin"],
                "t_end": now,
                "wall_s": round(max(now - act["t_begin"], 0.0), 6),
                "overhead_s": round(overhead, 6),
                "dir": self._rel(act["dir"]),
            }
            if force and step_end < act["end_step"]:
                row["aborted"] = True
            self.rows.append(row)
            self._write_row(row)
        record_event(
            "capture_end", step=row["step_end"], id=act["id"],
            trigger=act["trigger"], wall_s=row["wall_s"],
            overhead_s=row["overhead_s"], dir=row["dir"],
        )
        logger.info(
            "capture %d (%s) closed: steps %d..%d, %.3fs wall "
            "(%.3fs start/stop overhead) -> %s",
            act["id"], act["trigger"], row["step_begin"], row["step_end"],
            row["wall_s"], row["overhead_s"], act["dir"],
        )
        return row

    def abort(self, step: int | None = None) -> dict[str, Any] | None:
        """Fit-exit cleanup: close a still-open window (manifest row gets
        ``aborted: true`` if it never reached its end step) and drop any
        never-started armed/scheduled requests (refunding their budget
        charge — they produced nothing).  Idempotent."""
        dropped = []
        with self._lock:
            for req in (self._armed, self._scheduled):
                if req is not None:
                    dropped.append(req)
                    if req["budget"]:
                        self._used -= 1
            self._armed = self._scheduled = None
        for req in dropped:
            logger.warning(
                "armed capture (%s) never started: the run ended first",
                req["trigger"],
            )
        act = self._active
        if act is None:
            return None
        return self.maybe_stop(
            step if step is not None else act["step_begin"], force=True
        )

    # -- state ---------------------------------------------------------------

    def state(self) -> dict[str, Any]:
        """The ``/profilez`` GET payload: budget, armed/active window,
        completed rows."""
        with self._lock:
            cooldown_left = 0.0
            if self._last_end_t is not None:
                cooldown_left = max(
                    self.cooldown_s - (self._time() - self._last_end_t), 0.0
                )
            return {
                "max_captures": self.max_captures,
                "used": self._used,
                "cooldown_s": self.cooldown_s,
                "cooldown_remaining_s": round(cooldown_left, 1),
                "window_steps": self.window_steps,
                "armed": dict(self._armed) if self._armed else None,
                "scheduled": (
                    dict(self._scheduled) if self._scheduled else None
                ),
                "active": (
                    {k: v for k, v in self._active.items()}
                    if self._active else None
                ),
                "captures": [dict(r) for r in self.rows],
            }

    # -- internals -----------------------------------------------------------

    def _rel(self, cap_dir: str) -> str:
        """Manifest-relative capture dir: relative to the manifest's
        directory when it nests there (survives logdir relocation), else
        absolute (an explicit ``--profile-dir`` elsewhere — the schema
        checker resolves relative dirs against the manifest's directory,
        so a cwd-relative path would dangle)."""
        if self.manifest_path is None:
            return cap_dir
        base = os.path.dirname(os.path.abspath(self.manifest_path))
        abs_dir = os.path.abspath(cap_dir)
        rel = os.path.relpath(abs_dir, base)
        return abs_dir if rel.startswith("..") else rel

    def _write_row(self, row: dict[str, Any]) -> None:
        if self.manifest_path is None:
            return
        if self._chief_pending:
            self._chief_pending = False
            if bootstrap.process_index() != 0:
                self.manifest_path = None
                return
        from ..utils.metrics import json_sanitize  # noqa: PLC0415

        try:
            os.makedirs(
                os.path.dirname(self.manifest_path) or ".", exist_ok=True
            )
            with open(self.manifest_path, "a") as f:
                f.write(json.dumps(json_sanitize(row), allow_nan=False) + "\n")
        except (OSError, ValueError):  # full disk etc. — never fatal
            logger.exception(
                "capture manifest write to %s failed", self.manifest_path
            )


_default: CaptureEngine | None = None
_default_lock = threading.Lock()


def default_engine() -> CaptureEngine | None:
    """The process-default engine, or None when none is installed."""
    return _default


def install_engine(eng: CaptureEngine | None) -> CaptureEngine | None:
    """Install ``eng`` as the process default (None uninstalls); returns
    the previous one.  The StatusServer's ``/profilez`` falls back to the
    default when not handed an engine explicitly."""
    global _default
    with _default_lock:
        prev, _default = _default, eng
    return prev
