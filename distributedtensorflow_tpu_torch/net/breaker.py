"""Per-endpoint circuit breakers for the resilient RPC substrate.

Twin of ``distributedtensorflow_tpu/net/breaker.py``, framework-free and
copied whole but for the telemetry, which always writes to the port's
registry (``obs.registry``).

A breaker sits in front of every :mod:`net.rpc` endpoint and turns a
*persistently* failing peer into a fast local failure instead of a queue
of doomed connect attempts, each burning its full timeout (the classic
closed/open/half-open state machine):

- ``closed``    — healthy; calls pass through.  ``failure_threshold``
  CONSECUTIVE failures trip it open (one success resets the streak).
- ``open``      — calls fail immediately with :class:`BreakerOpenError`
  (no socket is touched) until ``open_for_s`` has elapsed.
- ``half_open`` — after the cooldown exactly ONE probe call is let
  through; its success closes the breaker, its failure re-opens it for a
  fresh cooldown.

Telemetry (the obs registry):
``breaker_state{endpoint}`` gauge encoding the state numerically
(0 = closed, 1 = half_open, 2 = open) and
``breaker_transitions_total{endpoint,to}`` counting every state change —
the counter is what makes an open → half_open → closed recovery cycle
visible in a post-hoc ``metrics.prom`` snapshot, where the gauge only
shows the final state.

Breakers are process-global, keyed by the caller-supplied endpoint
identity string (:func:`breaker_for`); use one identity per failure
domain — e.g. ``"dispatcher"`` but ``"data_worker:<addr>"`` — so one
dead worker can never trip the breaker of its healthy siblings.
"""

from __future__ import annotations

import threading
import time

from ..obs.registry import counter as _counter
from ..obs.registry import gauge as _gauge

__all__ = [
    "BREAKER_STATES",
    "BreakerOpenError",
    "CircuitBreaker",
    "breaker_for",
    "reset_breakers",
]

#: The states, in gauge-encoding order: ``breaker_state{endpoint}`` is
#: the state's index in this tuple (0 closed, 1 half_open, 2 open).
BREAKER_STATES = ("closed", "half_open", "open")

_G_STATE = _gauge(
    "breaker_state",
    "circuit breaker state per endpoint (0=closed, 1=half_open, 2=open)",
)
_M_TRANSITIONS = _counter(
    "breaker_transitions_total",
    "circuit breaker state transitions, by endpoint and target state",
)


class BreakerOpenError(ConnectionError):
    """Raised by :meth:`CircuitBreaker.check` / ``net.rpc.call`` when the
    endpoint's breaker is open — the call failed locally, without
    touching the network.  Subclasses ``ConnectionError`` so existing
    fault policies (elastic eviction, supervisor classification) treat it
    exactly like the refused connection it stands in for."""


class CircuitBreaker:
    """One endpoint's closed/open/half-open state machine (thread-safe).

    ``clock`` is injectable (tests drive transitions without sleeping);
    defaults to ``time.monotonic``.
    """

    def __init__(
        self,
        endpoint: str,
        *,
        failure_threshold: int = 5,
        open_for_s: float = 2.0,
        clock=time.monotonic,
    ):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}"
            )
        self.endpoint = str(endpoint)
        self.failure_threshold = int(failure_threshold)
        self.open_for_s = float(open_for_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0  # consecutive failures while closed
        self._opened_at = 0.0
        self._probing = False  # a half-open probe is in flight
        _G_STATE.set(0, endpoint=self.endpoint)

    # -- state ---------------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    def _transition_locked(self, to: str) -> None:
        if to == self._state:
            return
        self._state = to
        _G_STATE.set(BREAKER_STATES.index(to), endpoint=self.endpoint)
        _M_TRANSITIONS.inc(endpoint=self.endpoint, to=to)

    def _maybe_half_open_locked(self) -> None:
        if self._state == "open" \
                and self._clock() - self._opened_at >= self.open_for_s:
            self._transition_locked("half_open")
            self._probing = False

    # -- call-site protocol --------------------------------------------------

    def allow(self) -> bool:
        """True when a call may proceed: always while closed; exactly one
        probe per half-open window; never while open (pre-cooldown)."""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == "closed":
                return True
            if self._state == "half_open" and not self._probing:
                self._probing = True
                return True
            return False

    def check(self) -> None:
        """:meth:`allow` or raise :class:`BreakerOpenError`."""
        if not self.allow():
            raise BreakerOpenError(
                f"circuit breaker for {self.endpoint!r} is "
                f"{self.state} (endpoint failing; backing off)"
            )

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state in ("half_open", "open"):
                # open → closed happens when a call raced the trip: it was
                # admitted while closed and finished after the breaker
                # opened — the endpoint evidently answers again.
                self._transition_locked("closed")
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            if self._state == "half_open":
                # failed probe: back to open for a fresh cooldown
                self._opened_at = self._clock()
                self._transition_locked("open")
                self._probing = False
                return
            self._failures += 1
            if self._state == "closed" \
                    and self._failures >= self.failure_threshold:
                self._opened_at = self._clock()
                self._transition_locked("open")


_BREAKERS: dict[str, CircuitBreaker] = {}
_BREAKERS_LOCK = threading.Lock()


def breaker_for(endpoint: str, *, failure_threshold: int = 5,
                open_for_s: float = 2.0) -> CircuitBreaker:
    """The process-global breaker for ``endpoint`` (created on first use;
    the construction-time knobs of the first caller win)."""
    with _BREAKERS_LOCK:
        b = _BREAKERS.get(endpoint)
        if b is None:
            b = CircuitBreaker(
                endpoint,
                failure_threshold=failure_threshold,
                open_for_s=open_for_s,
            )
            _BREAKERS[endpoint] = b
        return b


def reset_breakers() -> None:
    """Drop every process-global breaker (test isolation)."""
    with _BREAKERS_LOCK:
        _BREAKERS.clear()
