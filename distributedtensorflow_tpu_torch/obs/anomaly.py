"""Streaming anomaly detection over the training metric stream.

Twin of ``distributedtensorflow_tpu/obs/anomaly.py``, framework-free and
copied whole.

Three detectors, all O(1) per observation over bounded trailing windows:

- **non-finite loss** — NaN/Inf the step it appears (no history needed);
- **loss spike** — z-score of the new loss against the trailing window's
  mean/std exceeds ``z_threshold``;
- **step-time regression** — the window-averaged step time exceeds
  ``step_time_factor``× the trailing median (median, not mean: robust to
  the occasional checkpoint/eval-inflated window).

Anomalies raise through the :class:`~..utils.watchdog.Watchdog` callback
convention: ``on_anomaly`` is invoked per anomaly, exceptions in it are
logged and swallowed (an alerting hook must never kill the fit), and the
Trainer's default hook logs, counts (``anomalies_total{kind=...}``), writes
a ``trace.jsonl`` event, and fans out to ``Callback.on_anomaly``.

The Trainer feeds the detector at **log boundaries** (where it fetches the
loss anyway) — observing every step would force a device sync per dispatch
and destroy async-dispatch pipelining.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import math
import statistics
from collections.abc import Callable

logger = logging.getLogger(__name__)

__all__ = ["Anomaly", "AnomalyDetector", "zscore"]


def zscore(values, value: float) -> float:
    """How many sigma ``value`` sits from ``values``' mean, with a
    relative std floor: a bitwise-constant plateau (pstdev 0) must not
    turn float jitter into a spike.  The loss-spike detector's math,
    exposed for any series (``obs.alerts`` anomaly rules)."""
    mean = statistics.fmean(values)
    std = statistics.pstdev(values)
    return abs(value - mean) / max(std, 1e-6 * max(abs(mean), 1.0))


@dataclasses.dataclass(frozen=True)
class Anomaly:
    kind: str  # non_finite_loss | loss_spike | step_time_regression
    step: int
    message: str
    value: float


class AnomalyDetector:
    """Feed it ``observe(step, loss=, step_time=)``; get back anomalies.

    ``warmup`` step-time observations are skipped before the regression
    check arms (the first window holds the first step's kernel loads and
    would trivially trip it).  ``min_history`` observations are required before
    the statistical checks fire at all.
    """

    def __init__(
        self,
        *,
        z_threshold: float = 6.0,
        step_time_factor: float = 3.0,
        window: int = 64,
        min_history: int = 8,
        warmup: int = 1,
        on_anomaly: Callable[[Anomaly], None] | None = None,
    ):
        if window < min_history:
            raise ValueError(
                f"window={window} smaller than min_history={min_history}"
            )
        self.z_threshold = z_threshold
        self.step_time_factor = step_time_factor
        self.min_history = min_history
        self._on_anomaly = on_anomaly
        self._losses: collections.deque[float] = collections.deque(maxlen=window)
        self._times: collections.deque[float] = collections.deque(maxlen=window)
        self._time_skips = warmup
        self.anomalies: list[Anomaly] = []

    def observe(
        self,
        step: int,
        *,
        loss: float | None = None,
        step_time: float | None = None,
    ) -> list[Anomaly]:
        """Check one observation; returns (and records, and calls
        ``on_anomaly`` for) any anomalies found."""
        found: list[Anomaly] = []
        if loss is not None:
            loss = float(loss)
            if not math.isfinite(loss):
                found.append(Anomaly(
                    "non_finite_loss", step,
                    f"loss is {loss} at step {step}", loss,
                ))
            else:
                if len(self._losses) >= self.min_history:
                    mean = statistics.fmean(self._losses)
                    z = zscore(self._losses, loss)
                    if z > self.z_threshold:
                        found.append(Anomaly(
                            "loss_spike", step,
                            f"loss {loss:.6g} is {z:.1f} sigma from the "
                            f"trailing mean {mean:.6g} at step {step}", loss,
                        ))
                self._losses.append(loss)
        if step_time is not None and step_time > 0:
            if self._time_skips > 0:
                self._time_skips -= 1  # compile-inflated first window(s)
            else:
                if len(self._times) >= self.min_history:
                    med = statistics.median(self._times)
                    if med > 0 and step_time > self.step_time_factor * med:
                        found.append(Anomaly(
                            "step_time_regression", step,
                            f"step time {step_time:.4g}s is "
                            f"{step_time / med:.1f}x the trailing median "
                            f"{med:.4g}s at step {step}", step_time,
                        ))
                self._times.append(float(step_time))
        for a in found:
            self.anomalies.append(a)
            self._dispatch(a)
        return found

    def observe_record(self, record: dict) -> list[Anomaly]:
        """Convenience for replaying a ``metrics.jsonl`` row (the
        ``tools/run_report.py`` offline path): pulls ``loss`` and ``t_step``
        if present."""
        step = int(record.get("step", -1))
        loss = record.get("loss")
        return self.observe(
            step,
            loss=loss if isinstance(loss, (int, float)) else None,
            step_time=record.get("t_step"),
        )

    def _dispatch(self, a: Anomaly) -> None:
        if self._on_anomaly is None:
            logger.error("anomaly: %s", a.message)
            return
        try:
            self._on_anomaly(a)
        except Exception:  # the Watchdog on_timeout contract
            logger.exception("anomaly callback failed for %s", a)
