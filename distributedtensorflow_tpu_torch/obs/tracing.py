"""Lightweight span tracing: wall-time trees per training step.

Twin of ``distributedtensorflow_tpu/obs/tracing.py`` (``:69-416``),
framework-free and copied whole but for the chief check, which asks
:func:`..parallel.bootstrap.process_index`.  Spans time the host: on the
card a step's dispatch returns before its kernels end, so the
``train_step`` span is the launch and the ``host_block`` span at a log
boundary the wait for the device, as on the TPU.

``with span("data_wait"): ...`` times a region.  Spans nest per thread
(children attach to the enclosing span); a completed *root* span is
delivered to the installed :class:`TraceRecorder`, which groups roots into
per-step rows, writes them to ``trace.jsonl``, and accumulates per-name
window totals the Trainer turns into the step-time breakdown
(data-wait / compute-dispatch / host-blocking / checkpoint / eval).

Design constraints:

- ``span`` must be exception-transparent — the Trainer's fit loop relies on
  ``StopIteration`` from ``next(it)`` escaping unchanged, so ``span`` is a
  plain class context manager, NOT a ``@contextmanager`` generator (PEP 479
  would turn an in-body StopIteration into RuntimeError).
- near-zero cost when no recorder is installed: two ``perf_counter`` calls
  and a list push/pop;
- spans may complete on any thread (the Prefetcher's ``device_put`` worker);
  roots from any thread land in the currently open step row.

``trace.jsonl`` row schema (one JSON object per line)::

    {"step": int, "k": int, "t_wall": float,
     "spans": [{"name": str, "dur_s": float, "children": [...]}, ...]}
    {"kind": "anomaly", "step": int, "anomaly": str, "message": str,
     "value": float}
    {"kind": "span", "name": str, "trace_id": str, "span_id": str,
     "parent_id": str?, "t0": float unix seconds, "dur_s": float,
     "proc": int, ...}

The ``kind: "span"`` rows are **cross-process trace spans** (the fleet
observability plane, ISSUE 11): unlike the per-step span trees they carry
absolute wall-clock ``t0`` and a ``trace_id`` shared across process
boundaries, so ``tools/timeline.py --fleet`` can stitch a client span in
one process's ``trace.jsonl`` against the dispatcher/worker spans it
caused in another's.  The context travels as a two-field dict
``{"trace_id", "span_id"}``: the data service injects it into its RPC
frames and reads it back (``data/service.py``), and the serving engine
records the spans of requests that carry one (``serve/engine.py``), as
the JAX package's layers do.  :class:`remote_span` is the emitting
context manager (near-free when no recorder is installed).
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Any

from ..parallel import bootstrap

__all__ = [
    "Span",
    "span",
    "TraceRecorder",
    "active_recorder",
    "add_root_sink",
    "remove_root_sink",
    "current_context",
    "new_trace_id",
    "new_span_id",
    "record_remote_span",
    "remote_span",
]

_tls = threading.local()


class Span:
    __slots__ = ("name", "t0", "dur_s", "children")

    def __init__(self, name: str):
        self.name = name
        self.t0 = 0.0
        self.dur_s = 0.0
        self.children: list[Span] = []

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {"name": self.name, "dur_s": round(self.dur_s, 6)}
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d


class span:
    """``with span("train_step"): ...`` — time a region into the trace."""

    __slots__ = ("_span",)

    def __init__(self, name: str):
        self._span = Span(name)

    def __enter__(self) -> Span:
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        self._span.t0 = time.perf_counter()
        stack.append(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        s = self._span
        s.dur_s = time.perf_counter() - s.t0
        stack = _tls.stack
        stack.pop()
        if stack:
            stack[-1].children.append(s)
        else:
            rec = _recorder
            if rec is not None:
                rec._add_root(s)
            for sink in _root_sinks:
                # A sink raising inside __exit__ would REPLACE the body's
                # in-flight exception (StopIteration ends the fit loop) —
                # swallow unconditionally; sinks are telemetry, not logic.
                try:
                    sink(s)
                except Exception:
                    pass
        return False


_recorder: "TraceRecorder | None" = None
_recorder_lock = threading.Lock()

#: Extra consumers of completed ROOT spans (the goodput ledger) — fed even
#: when no TraceRecorder is installed, so pre-fit spans (checkpoint
#: restore, AOT cost-estimate compile) are observable.  A tuple: reads on
#: the span hot path are lock-free snapshots.
_root_sinks: tuple = ()


def add_root_sink(fn) -> None:
    """Register ``fn(span)`` to receive every completed root span."""
    global _root_sinks
    with _recorder_lock:
        if fn not in _root_sinks:
            _root_sinks = _root_sinks + (fn,)


def remove_root_sink(fn) -> None:
    global _root_sinks
    with _recorder_lock:
        _root_sinks = tuple(f for f in _root_sinks if f is not fn)


def active_recorder() -> "TraceRecorder | None":
    return _recorder


class TraceRecorder:
    """Collects root spans into per-step rows and window totals.

    ``path=None`` keeps the recorder accounting-only (window totals for the
    breakdown, no file) — the Trainer installs one per fit either way.
    Only the chief process writes the file (the ``MetricWriter``
    convention); non-chief recorders still accumulate window totals so
    cross-host aggregation has per-host numbers to gather.
    """

    def __init__(self, path: str | None = None, *, chief_only: bool = True):
        self._f = None
        if path is not None:
            chief = True
            if chief_only:
                chief = bootstrap.process_index() == 0
            if chief:
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                self._f = open(path, "a")
        self._lock = threading.Lock()
        self._step: int | None = None
        self._k = 1
        self._step_t0 = 0.0
        self._roots: list[Span] = []
        self._window: dict[str, float] = {}
        self._window_counts: dict[str, int] = {}

    # -- install / uninstall -------------------------------------------------

    def install(self) -> "TraceRecorder":
        global _recorder
        with _recorder_lock:
            _recorder = self
        return self

    def uninstall(self) -> None:
        global _recorder
        with _recorder_lock:
            if _recorder is self:
                _recorder = None

    def __enter__(self) -> "TraceRecorder":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()
        self.close()

    # -- span intake ---------------------------------------------------------

    def _add_root(self, s: Span) -> None:
        with self._lock:
            self._roots.append(s)
            self._window[s.name] = self._window.get(s.name, 0.0) + s.dur_s
            self._window_counts[s.name] = self._window_counts.get(s.name, 0) + 1

    # -- step grouping -------------------------------------------------------

    def begin_step(self, step: int, k: int = 1) -> None:
        """Open a step row; roots completing until ``end_step`` belong to it.

        An already-open row is flushed first, so a loop that only calls
        ``begin_step`` still emits every row.
        """
        with self._lock:
            if self._step is not None:
                self._flush_row_locked()
            self._step = step
            self._k = k
            self._step_t0 = time.perf_counter()
            self._roots = []

    def adjust_step(self, step: int, k: int = 1) -> None:
        """Relabel the open row — for callers whose step count is only
        final after the data fetch (a short prebundled trailing bundle
        shrinks the dispatch below the projected k)."""
        with self._lock:
            if self._step is not None:
                self._step = step
                self._k = k

    def end_step(self) -> None:
        with self._lock:
            self._flush_row_locked()

    def _flush_row_locked(self) -> None:
        if self._step is None:
            # roots outside any step (e.g. the final checkpoint after the
            # loop): emit them unanchored so the wall time is not lost.
            if self._roots and self._f is not None:
                self._write(
                    {"step": None,
                     "spans": [s.to_dict() for s in self._roots]}
                )
            self._roots = []
            return
        row = {
            "step": self._step,
            "k": self._k,
            "t_wall": round(time.perf_counter() - self._step_t0, 6),
            "spans": [s.to_dict() for s in self._roots],
        }
        self._step = None
        self._roots = []
        if self._f is not None:
            self._write(row)

    def write_event(self, event: dict[str, Any]) -> None:
        """Append an out-of-band row (anomalies, run markers)."""
        with self._lock:
            if self._f is not None:
                self._write(event)

    def _write(self, row: dict[str, Any]) -> None:
        from ..utils.metrics import json_sanitize  # noqa: PLC0415

        # allow_nan=False + sentinel strings: an anomaly event's value is
        # often NaN, and a bare NaN token is invalid strict JSON.
        self._f.write(json.dumps(json_sanitize(row), allow_nan=False) + "\n")
        self._f.flush()

    # -- breakdown window ----------------------------------------------------

    def drain_window(self) -> dict[str, float]:
        """Return and reset per-span-name total seconds since last drain.

        The Trainer divides these by the window's optimizer-step count to
        get the per-step breakdown fields.
        """
        with self._lock:
            totals, self._window = self._window, {}
            self._window_counts = {}
            return totals

    def close(self) -> None:
        with self._lock:
            self._flush_row_locked()
            if self._f is not None:
                self._f.close()
                self._f = None


# -- cross-process trace context (fleet observability plane) -----------------

_ctx_tls = threading.local()


def new_trace_id() -> str:
    """A fresh 16-hex-char trace id (shared across every process a
    request touches)."""
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    """A fresh 16-hex-char span id (unique per emitted span)."""
    return uuid.uuid4().hex[:16]


def current_context() -> dict[str, str] | None:
    """The calling thread's live trace context ``{"trace_id", "span_id"}``
    (the innermost open :class:`remote_span`), or None.  The returned dict
    is the wire-injectable form — put it in an RPC frame verbatim and the
    receiving process opens its span with ``remote_span(..., context=...)``
    to parent under it."""
    ctx = getattr(_ctx_tls, "ctx", None)
    return dict(ctx) if ctx else None


def record_remote_span(
    name: str,
    *,
    t0: float,
    dur_s: float,
    trace_id: str,
    span_id: str | None = None,
    parent_id: str | None = None,
    **fields: Any,
) -> dict[str, Any] | None:
    """Write one already-measured cross-process span row to the active
    recorder's ``trace.jsonl`` (the ``kind: "span"`` schema above).

    ``t0`` is absolute unix seconds — cross-process stitching cannot use
    the per-step rows' relative durations.  No-op (returns None) when no
    recorder is installed or it has no file; never raises (spans are
    telemetry, not logic)."""
    rec = _recorder
    if rec is None:
        return None
    row: dict[str, Any] = {
        "kind": "span",
        "name": str(name),
        "trace_id": str(trace_id),
        "span_id": str(span_id or new_span_id()),
        "t0": round(float(t0), 6),
        "dur_s": round(max(float(dur_s), 0.0), 6),
        "proc": os.getpid(),
    }
    if parent_id:
        row["parent_id"] = str(parent_id)
    row.update(fields)
    try:
        rec.write_event(row)
    except Exception:
        return None
    return row


class remote_span:
    """``with remote_span("data_service.fetch_split", split=3): ...`` —
    a cross-process span: absolute wall-clock timing plus trace-context
    propagation.

    On entry it resolves its trace context — an explicit ``context``
    (the ``{"trace_id", "span_id"}`` dict received over the wire, which
    becomes the parent), else the thread's current context, else a fresh
    trace — and installs itself as the thread's current context so nested
    ``remote_span``s and wire injections (:func:`current_context`) parent
    correctly.  On exit it restores the previous context and writes one
    ``kind: "span"`` row via :func:`record_remote_span`.

    Exception-transparent (plain class context manager, the ``span``
    rule) and near-free when no recorder is installed.  ``.context`` is
    readable while open AND after exit — a client stores it to parent
    later work under the same span."""

    __slots__ = ("name", "fields", "trace_id", "span_id", "parent_id",
                 "row", "_t0", "_prev")

    def __init__(self, name: str, *, context: dict | None = None,
                 **fields: Any):
        self.name = name
        self.fields = fields
        parent = context if isinstance(context, dict) else None
        if parent is None or not parent.get("trace_id"):
            parent = getattr(_ctx_tls, "ctx", None)
        self.trace_id = str((parent or {}).get("trace_id") or new_trace_id())
        self.parent_id = (parent or {}).get("span_id")
        self.span_id = new_span_id()
        self.row: dict[str, Any] | None = None
        self._t0 = 0.0
        self._prev = None

    @property
    def context(self) -> dict[str, str]:
        """Wire-injectable ``{"trace_id", "span_id"}`` of THIS span."""
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    def __enter__(self) -> "remote_span":
        self._prev = getattr(_ctx_tls, "ctx", None)
        _ctx_tls.ctx = {"trace_id": self.trace_id, "span_id": self.span_id}
        self._t0 = time.time()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = time.time() - self._t0
        _ctx_tls.ctx = self._prev
        self.row = record_remote_span(
            self.name, t0=self._t0, dur_s=dur, trace_id=self.trace_id,
            span_id=self.span_id, parent_id=self.parent_id, **self.fields,
        )
        return False
