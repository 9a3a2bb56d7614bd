"""Goodput ledger: end-to-end wall-time accounting across restarts.

Twin of ``distributedtensorflow_tpu/obs/goodput.py``, framework-free and
copied but for the chief check (:func:`..parallel.bootstrap.process_index`)
and the elastic-resize hooks, which wait for the port's resize
controller (:meth:`GoodputLedger.note_restart` books the supervisor's
in-process restarts).  Spans and flight events answer
"where did *this step's* time go" and "is the run alive right now"; the
ledger answers the question that decides what a run costs: of the total
wall-clock it consumed — first-dispatch kernel loads, checkpoint stalls,
preemptions, restarts, lost work included — what fraction was
productive training?

Every wall-second of a run is classified into exactly one bucket:

==================== =======================================================
bucket               meaning
==================== =======================================================
``init``             process setup: mesh build, state creation, everything
                     before the fit loop that no span claims
``compile``          the engine's first-dispatch ``compile_*`` spans,
                     wherever they nest (on the card: the kernels' first
                     load, cuBLAS's start-up and the first step itself)
``train_step``       productive training: step dispatch + the host metric
                     fetch that syncs it (device is computing either way)
``data_wait``        the fit loop blocking on the input pipeline
``checkpoint_save``  blocking save + wait time
``checkpoint_restore`` restore + resume input fast-forward
``eval``             in-loop and sidecar evaluation
``preemption_drain`` preemption notice → process exit, minus the save
                     (which books under ``checkpoint_save``)
``profile_capture``  profiler start/stop overhead of CaptureEngine
                     windows (the profiled steps themselves still book
                     under ``train_step`` — they ran)
``lost_work``        wall time a dead generation spent past the checkpoint
                     the next generation resumed from — recomputed at merge
``resize``           an elastic resize window (the JAX package's
                     ``resilience.elastic``; nothing books it here yet)
``badput_restart``   the gap between a generation's last heartbeat and the
                     next generation's start (scheduler + restart latency)
``other``            in-fit wall time no span claims (host Python, logging)
==================== =======================================================

Accounting model — no new timers on the hot path:

- **Spans feed the buckets.**  Completed *root* spans are forwarded here by
  ``tracing`` (:func:`tracing.add_root_sink`) whether or not a
  ``TraceRecorder`` is installed, so pre-fit spans (``checkpoint_restore``,
  ``input_fastforward``) are captured too.  ``compile_*``
  child spans are carved out of their parent's bucket.
- **Flight events feed the markers.**  ``FlightRecorder.record`` forwards
  every event kind here: a ``preemption`` event stamps the drain window,
  and low-rate kinds are counted per generation for the report.
- **Derived buckets close the sum.**  ``init``, ``preemption_drain`` and
  ``other`` are computed from wall-clock stamps minus span-attributed
  seconds, so a generation's buckets sum to its wall time by construction
  (clamped at 0; main-thread spans are sequential, so overlap is nil).

Restart persistence: the ledger writes ``<logdir>/goodput.json``
incrementally (atomic tmp+rename, chief process only) and **re-loads it on
construction**, so a run that dies and resumes accumulates one honest
ledger across process generations.

Restart-merge rule: for every dead generation, the wall time between the
save of the checkpoint the *next* generation resumed from and the dead
generation's last heartbeat is moved into ``lost_work`` (deducted
proportionally across the generation's buckets — the interval's exact
composition died with the process); a generation followed by a cold
restart (nothing restored) is lost in full.  The heartbeat-to-next-start
gap books under ``badput_restart``.  A generation that ended ``"clean"``
is exempt from both: a later continue-training run in the same logdir is
intentional, not a restart — neither the between-runs gap nor the
post-final-save tail is badput.

Surfaces: per-bucket ``goodput_seconds_total{bucket=...}`` counters and a
``goodput_fraction`` gauge in the registry (``metrics.prom`` / ``/varz``),
the ``/goodputz`` endpoint on the :class:`~.server.StatusServer`, a
"Goodput" section in ``tools/run_report.py``, and periodic ``goodput``
flight-recorder events at every Trainer log boundary.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any

from ..parallel import bootstrap
from . import tracing
from .registry import counter, gauge

logger = logging.getLogger(__name__)

__all__ = [
    "BUCKETS",
    "GoodputLedger",
    "default_ledger",
    "install_ledger",
    "merge_generations",
    "note_checkpoint",
    "note_event",
    "note_restore",
]

#: The exclusive wall-time buckets (see module docstring).
BUCKETS = (
    "init",
    "compile",
    "train_step",
    "data_wait",
    "checkpoint_save",
    "checkpoint_restore",
    "eval",
    "preemption_drain",
    "profile_capture",
    "resize",
    "lost_work",
    "badput_restart",
    "other",
)

#: Root-span name → bucket.  ``host_block`` (the log-boundary metric fetch)
#: counts as train_step: the host is blocked because the device is still
#: executing dispatched steps.  Unknown span names stay in ``other``.
_SPAN_BUCKETS = {
    "data_wait": "data_wait",
    "train_step": "train_step",
    "host_block": "train_step",
    "eval": "eval",
    "sidecar_eval": "eval",
    "checkpoint_save": "checkpoint_save",
    "checkpoint_wait": "checkpoint_save",
    "checkpoint_restore": "checkpoint_restore",
    "input_fastforward": "checkpoint_restore",
    "profile_capture": "profile_capture",
}

#: Flight-event kinds NOT counted per generation (per-dispatch rate, or
#: emitted by this module itself).
_UNCOUNTED_EVENTS = frozenset({"step", "log", "goodput"})

# Registry handles, resolved once (hot-path discipline; see the
# set_default_registry scope caveat in registry.py).
_M_SECONDS = counter(
    "goodput_seconds_total", "merged wall seconds by goodput bucket"
)
_M_FRACTION = gauge(
    "goodput_fraction", "train_step seconds / total wall seconds, merged"
)
_M_WALL = gauge(
    "goodput_wall_seconds", "merged wall seconds across all generations"
)


def _compile_seconds(span) -> float:
    """Total seconds of ``compile*``-named descendants (not recursing into
    a compile span — its children are part of the compile)."""
    total = 0.0
    for child in getattr(span, "children", ()) or ():
        if child.name.startswith("compile"):
            total += child.dur_s
        else:
            total += _compile_seconds(child)
    return total


def _lost_seconds(gen: dict, resumed_step) -> float:
    """Wall seconds generation ``gen`` spent past the checkpoint the next
    generation resumed from (the restart-merge rule)."""
    start = float(gen.get("start_t", 0.0))
    last = float(gen.get("last_t", start))
    if resumed_step is None:  # cold restart: nothing carried over
        return max(last - start, 0.0)
    ckpts = [
        (int(s), float(t)) for s, t in (gen.get("ckpts") or [])
    ]
    exact = [t for s, t in ckpts if s == int(resumed_step)]
    if exact:
        ref = max(exact)
    else:
        older = [t for s, t in ckpts if s <= int(resumed_step)]
        ref = max(older) if older else start
    return max(last - ref, 0.0)


def merge_generations(gens: list[dict]) -> dict[str, Any]:
    """Fold per-generation records into one cross-restart ledger.

    Applies the restart-merge rule between consecutive generations (see
    module docstring); the merged buckets stay exclusive and sum to the
    merged wall time because both moves are zero-sum (``lost_work`` is
    deducted from the donor generation's buckets, ``badput_restart`` adds
    the same gap seconds to buckets and wall).
    """
    buckets: dict[str, float] = {}
    events: dict[str, int] = {}
    wall = 0.0
    for i, g in enumerate(gens):
        start = float(g.get("start_t", 0.0))
        last = float(g.get("last_t", start))
        wall += max(last - start, 0.0)
        gb = {
            str(k): max(float(v), 0.0)
            for k, v in (g.get("buckets") or {}).items()
        }
        for k, n in (g.get("events") or {}).items():
            events[k] = events.get(k, 0) + int(n)
        nxt = gens[i + 1] if i + 1 < len(gens) else None
        # The restart-merge rule applies to DEAD generations only
        # (preempted, or open = died mid-flight).  A generation that ended
        # "clean" followed by another run is intentional continue-training:
        # the between-runs gap is not restart badput and nothing past its
        # final save was lost.
        if nxt is not None and g.get("ended") != "clean":
            gap = max(float(nxt.get("start_t", last)) - last, 0.0)
            wall += gap
            buckets["badput_restart"] = (
                buckets.get("badput_restart", 0.0) + gap
            )
            lost = _lost_seconds(g, nxt.get("resumed_step"))
            total = sum(gb.values())
            if lost > 0 and total > 0:
                lost = min(lost, total)
                scale = 1.0 - lost / total
                for k in gb:
                    gb[k] *= scale
                buckets["lost_work"] = buckets.get("lost_work", 0.0) + lost
        for k, v in gb.items():
            buckets[k] = buckets.get(k, 0.0) + v
    frac = buckets.get("train_step", 0.0) / wall if wall > 0 else 0.0
    return {
        "wall_s": round(wall, 3),
        "buckets": {k: round(v, 3) for k, v in buckets.items() if v > 0},
        "goodput_fraction": round(min(max(frac, 0.0), 1.0), 4),
        "generations": len(gens),
        "restarts": max(len(gens) - 1, 0),
        "events": events,
    }


def _load_generations(path: str) -> list[dict]:
    """Prior generations from an existing ``goodput.json`` (empty on any
    problem — a corrupt ledger must never block a restart)."""
    try:
        with open(path) as f:
            obj = json.load(f)
    except FileNotFoundError:
        return []
    except (OSError, json.JSONDecodeError, ValueError):
        logger.warning("goodput: unreadable prior ledger at %s; starting "
                       "a fresh one", path)
        return []
    gens = obj.get("generations") if isinstance(obj, dict) else None
    if not isinstance(gens, list):
        return []
    return [g for g in gens if isinstance(g, dict)]


class GoodputLedger:
    """Classifies a process generation's wall time into exclusive buckets
    and merges it with prior generations loaded from ``path``.

    ``path=None`` keeps the ledger accounting-only (``report()`` and the
    registry still work; nothing persists — also the non-chief mode:
    with ``chief_only`` the path is dropped on a process other than the
    chief, so only one process writes the file).

    Install with :meth:`install` (the module-default slot, like the flight
    recorder's): the span-tracer sink and the deep-layer hooks
    (:func:`note_checkpoint` / :func:`note_restore` / flight events) all
    feed the installed ledger.
    """

    def __init__(self, path: str | None = None, *, chief_only: bool = True):
        self.path = path
        # Chiefness is resolved LAZILY at the first write, not here: the
        # entrypoint constructs the ledger BEFORE the process group starts,
        # when every process still reads as process 0.
        self._chief_pending = chief_only and path is not None
        self._prior: list[dict] = (
            _load_generations(path) if path is not None else []
        )
        self._lock = threading.Lock()
        self._gen = len(self._prior)
        self._start_t = time.time()
        self._last_t = self._start_t
        self._last_step: int | None = None
        self._ended: str | None = None
        self._resumed_step: int | None = None
        # span-attributed seconds by bucket; _attr_total is their sum
        self._buckets: dict[str, float] = {}
        self._attr_total = 0.0
        # phase stamps for the derived buckets
        self._fit_t: float | None = None
        self._init = 0.0
        self._preempt_t: float | None = None
        self._preempt_attr = 0.0
        self._ckpts: list[list[float]] = []
        self._events: dict[str, int] = {}
        # last value exported per bucket, for counter delta-incs
        self._prom_prev: dict[str, float] = {}

    # -- intake (span sink + deep-layer hooks) -------------------------------

    def observe_span(self, span) -> None:
        """Root-span sink: attribute a completed span tree to its bucket,
        carving ``compile_*`` descendants out into ``compile``."""
        name = span.name
        bucket = _SPAN_BUCKETS.get(name)
        if bucket is None and name.startswith("compile"):
            bucket = "compile"
        if bucket is None:
            return  # unknown spans stay in `other` via the wall residual
        dur = max(span.dur_s, 0.0)
        comp = 0.0
        if bucket != "compile":
            comp = min(_compile_seconds(span), dur)
            dur -= comp
        with self._lock:
            if dur:
                self._buckets[bucket] = self._buckets.get(bucket, 0.0) + dur
            if comp:
                self._buckets["compile"] = (
                    self._buckets.get("compile", 0.0) + comp
                )
            self._attr_total += dur + comp

    def note_checkpoint(self, step: int) -> None:
        """A checkpoint save was accepted at ``step`` — the lost-work
        anchor the next generation's resume is measured against."""
        with self._lock:
            self._ckpts.append([int(step), time.time()])

    def note_restore(self, step: int) -> None:
        """This generation resumed from the checkpoint at ``step``."""
        with self._lock:
            self._resumed_step = int(step)

    def note_restart(self, seconds: float) -> None:
        """An in-process supervised restart (``resilience.Supervisor``):
        book the failure-to-re-entry window (classification and backoff;
        the restore books under its own span) into ``badput_restart``, the
        bucket the cross-process merge uses for the heartbeat-to-restart
        gap.  Attributed like span seconds, so the ``other`` residual
        shrinks by the same amount and the buckets still sum to wall."""
        s = max(float(seconds), 0.0)
        if not s:
            return
        with self._lock:
            self._buckets["badput_restart"] = (
                self._buckets.get("badput_restart", 0.0) + s
            )
            self._attr_total += s

    def note_event(self, kind: str) -> None:
        """Flight-event tap: stamps the preemption-drain window and counts
        low-rate event kinds per generation."""
        with self._lock:
            if kind == "preemption" and self._preempt_t is None:
                self._preempt_t = time.time()
                self._preempt_attr = self._attr_total
            if kind in _UNCOUNTED_EVENTS:
                return
            self._events[kind] = self._events.get(kind, 0) + 1

    def mark_fit_begin(self, step: int | None = None) -> None:
        """Close the ``init`` window (first call wins; later fits in the
        same process only refresh the step)."""
        with self._lock:
            now = time.time()
            if self._fit_t is None:
                self._fit_t = now
                self._init = max(
                    (now - self._start_t) - self._attr_total, 0.0
                )
            if step is not None:
                self._last_step = int(step)

    # -- snapshot / merge ----------------------------------------------------

    def _gen_record_locked(self, now: float) -> dict[str, Any]:
        wall = max(now - self._start_t, 0.0)
        attr = self._attr_total
        init = (
            self._init if self._fit_t is not None
            else max(wall - attr, 0.0)
        )
        drain = 0.0
        if self._preempt_t is not None:
            drain = max(
                (now - self._preempt_t) - (attr - self._preempt_attr), 0.0
            )
        other = max(wall - init - drain - attr, 0.0)
        buckets = {
            k: round(v, 6) for k, v in self._buckets.items() if v > 0
        }
        buckets["init"] = round(init, 6)
        if drain > 0:
            buckets["preemption_drain"] = round(drain, 6)
        buckets["other"] = round(other, 6)
        return {
            "gen": self._gen,
            "start_t": self._start_t,
            "last_t": now,
            "last_step": self._last_step,
            "ended": self._ended,
            "resumed_step": self._resumed_step,
            "ckpts": [list(c) for c in self._ckpts],
            "events": dict(self._events),
            "buckets": buckets,
        }

    def report(self) -> dict[str, Any]:
        """The full ledger as of now: prior + live generation, merged.
        Read-only (no heartbeat advance, no file write) — the ``/goodputz``
        payload and the ``goodput.json`` document share this shape."""
        with self._lock:
            rec = self._gen_record_locked(time.time())
        gens = self._prior + [rec]
        return {
            "version": 1,
            "generations": gens,
            "merged": merge_generations(gens),
        }

    # -- flush ---------------------------------------------------------------

    def heartbeat(self, step: int | None = None) -> dict[str, Any]:
        """Advance the liveness stamp, refresh the registry metrics, emit a
        ``goodput`` flight event, and persist the ledger.  Called by the
        Trainer at every log boundary and on close; returns the merged
        view."""
        with self._lock:
            now = time.time()
            self._last_t = now
            if step is not None:
                self._last_step = int(step)
            rec = self._gen_record_locked(now)
        gens = self._prior + [rec]
        merged = merge_generations(gens)
        self._update_registry(merged)
        from .flight_recorder import record_event  # noqa: PLC0415

        record_event(
            "goodput", step=self._last_step,
            goodput_fraction=merged["goodput_fraction"],
            wall_s=merged["wall_s"],
        )
        self._write({"version": 1, "generations": gens, "merged": merged})
        return merged

    def close(self, ended: str = "clean") -> dict[str, Any]:
        """Mark how this generation ended (first mark wins — a preemption
        close must survive the entrypoint's clean close) and flush."""
        with self._lock:
            if self._ended is None:
                self._ended = ended
        return self.heartbeat()

    def _update_registry(self, merged: dict[str, Any]) -> None:
        for bucket, v in merged["buckets"].items():
            prev = self._prom_prev.get(bucket, 0.0)
            if v > prev:
                _M_SECONDS.inc(v - prev, bucket=bucket)
                self._prom_prev[bucket] = v
        _M_FRACTION.set(merged["goodput_fraction"])
        _M_WALL.set(merged["wall_s"])

    def _write(self, doc: dict[str, Any]) -> None:
        if self.path is None:
            return
        if self._chief_pending:
            # First write happens inside the fit (after the process group
            # started), so process_index() is meaningful by now.
            self._chief_pending = False
            if bootstrap.process_index() != 0:
                self.path = None  # accounting-only on non-chief processes
                return
        try:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            tmp = f"{self.path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, allow_nan=False)
                f.write("\n")
            os.replace(tmp, self.path)
        except (OSError, ValueError):  # full disk etc. — never fatal
            logger.exception("goodput ledger write to %s failed", self.path)

    # -- installation --------------------------------------------------------

    def install(self) -> "GoodputLedger":
        install_ledger(self)
        return self


_default: GoodputLedger | None = None
_default_lock = threading.Lock()


def default_ledger() -> GoodputLedger | None:
    """The process-default ledger, or None when none is installed."""
    return _default


def install_ledger(led: GoodputLedger | None) -> GoodputLedger | None:
    """Install ``led`` as the process default (None uninstalls); returns
    the previous one.  The span sink and deep-layer hooks feed whichever
    ledger is installed."""
    global _default
    with _default_lock:
        prev, _default = _default, led
    return prev


def note_checkpoint(step: int) -> None:
    """Deep-layer hook (checkpoint manager): no-op when no ledger."""
    led = _default
    if led is not None:
        led.note_checkpoint(step)


def note_restore(step: int) -> None:
    """Deep-layer hook (checkpoint manager): no-op when no ledger."""
    led = _default
    if led is not None:
        led.note_restore(step)


def note_restart(seconds: float) -> None:
    """Deep-layer hook (``resilience.Supervisor``): no-op when no
    ledger."""
    led = _default
    if led is not None:
        led.note_restart(seconds)


def note_event(kind: str) -> None:
    """Flight-recorder tap: no-op (one attribute read) when no ledger."""
    led = _default
    if led is not None:
        led.note_event(kind)


def _observe_root(span) -> None:
    led = _default
    if led is not None:
        led.observe_span(span)


# Completed root spans reach the installed ledger whether or not a
# TraceRecorder is installed (pre-fit restore/compile spans included).
tracing.add_root_sink(_observe_root)
