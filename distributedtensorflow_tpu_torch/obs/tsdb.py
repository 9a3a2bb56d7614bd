"""Embedded metrics history store: fixed-memory downsampling rings.

Twin of ``distributedtensorflow_tpu/obs/tsdb.py``, framework-free and
copied whole; it reads the port's registry (``obs.registry``).

The registry (``obs.registry``) and the fleet plane (``obs.fleet``)
expose *instantaneous* values only — ``/varz`` answers "what is the
queue depth now", never "what was it over the last five minutes".  The
SLO monitor keeps just enough windowed state for its own burn math, and
nothing else in the process remembers anything.  This module is the
missing history layer, sized for an embedded serving process rather
than a real TSDB:

- :class:`MetricsHistory` samples ``registry.scalars()`` (plus, when a
  ``FleetAggregator`` is attached, the fleet-merged ``median``/``max``
  per sample key, and, when SLO rules are attached, each rule's
  good/total snapshot via :func:`obs.slo.rule_history_samples`) on a
  background thread every ``interval_s``;
- each series lands in a **fixed-memory downsampling ring**: at most
  ``points_per_series`` points are retained — when the ring fills, the
  points are decimated 2:1 and the series' resolution doubles, so an
  arbitrarily long run keeps a full-span history at coarsening
  resolution in constant memory.  Series count is capped at
  ``max_series`` (new names past the cap are counted, not stored), so
  total memory is bounded regardless of run length or label cardinality;
- ``GET /histz`` (StatusServer extra route) answers windowed queries:
  ``?metric=<name>&window=<seconds>`` returns the in-window points plus
  the ring's current resolution; without ``metric`` it lists the series;
- with a ``logdir``, every sampling tick appends one
  ``{"t": ..., "values": {name: value, ...}}`` row to ``history.jsonl``
  (full resolution — downsampling applies to the in-memory ring only),
  the stream ``obs.slo.recompute_from_history`` replays to recompute
  burn rates offline and ``tools/check_metrics_schema.py`` validates.

Consumers: the serve entry point (``serve_torch.py``) installs one next
to the SLO monitor; ``train_torch.py --fleet`` attaches the fleet
aggregator so
the chief keeps a windowed history of the merged fleet view — the
windowed signals ROADMAP's disaggregated-router and QoS-admission items
need.
"""

from __future__ import annotations

import collections
import json
import logging
import math
import os
import re
import threading
import time

from . import registry as reglib

logger = logging.getLogger(__name__)

__all__ = ["MetricsHistory"]

#: Fleet-merged statistics mirrored into history series (``fleet.<key>.<stat>``).
FLEET_STATS = ("median", "max")

_LABELED_RE = re.compile(r"^([^{]+)\{(.*)\}$")
_LABEL_PAIR_RE = re.compile(r'(\w+)="([^"]*)"')


def _flat_name(key: str) -> str:
    """``name{k="v"}`` → ``name.k_v``: the registry's flat scalar form,
    so fleet-merged series pass the history.jsonl name schema."""
    m = _LABELED_RE.match(key)
    if not m:
        return key
    base, labels = m.groups()
    parts = [f"{k}_{reglib._NAME_RE.sub('_', v)}"
             for k, v in _LABEL_PAIR_RE.findall(labels)]
    return base + ("." + ".".join(parts) if parts else "")


class _Series:
    """One metric's downsampling ring: at most ``maxpoints`` ``(t, v)``
    points.  Points closer together than the current resolution merge
    into the newest bucket (latest value wins — right for gauges and for
    cumulative counters alike); on overflow the ring decimates 2:1 and
    the resolution doubles."""

    __slots__ = ("points", "maxpoints", "res_s")

    def __init__(self, maxpoints: int, res_s: float):
        self.points: collections.deque = collections.deque()
        self.maxpoints = maxpoints
        self.res_s = res_s

    def add(self, t: float, v: float) -> None:
        if self.points and t - self.points[-1][0] < self.res_s:
            self.points[-1] = (self.points[-1][0], v)
            return
        self.points.append((t, v))
        if len(self.points) > self.maxpoints:
            self.points = collections.deque(list(self.points)[::2])
            self.res_s *= 2.0


class MetricsHistory:
    """Sample the registry (and optional fleet/SLO surfaces) into
    bounded per-series rings; serve ``GET /histz``; append
    ``history.jsonl``.  Construct, :meth:`install` on a StatusServer,
    :meth:`start`; or drive :meth:`tick` synchronously (tests)."""

    def __init__(
        self,
        *,
        registry=None,
        interval_s: float = 2.0,
        points_per_series: int = 360,
        max_series: int = 512,
        logdir: str | None = None,
        rules=None,
        fleet=None,
        time_fn=time.time,
    ):
        self._reg = registry or reglib.default_registry()
        self.interval_s = max(float(interval_s), 0.05)
        self.points_per_series = max(int(points_per_series), 2)
        self.max_series = max(int(max_series), 1)
        self.rules = list(rules or [])
        self._fleet = fleet
        self._time = time_fn
        self._lock = threading.Lock()
        self._series: dict[str, _Series] = {}
        self._dropped: set[str] = set()  # names refused by the series cap
        self._pinned: set[str] = set()   # names with reserved capacity
        self.ticks = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._hist_log = None
        self._log_lock = threading.Lock()
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            self._hist_log = open(os.path.join(logdir, "history.jsonl"), "a")

    # -- sampling ------------------------------------------------------------

    def _collect(self) -> dict[str, float]:
        """One flat sample of every attached surface (finite values only)."""
        values = dict(self._reg.scalars())
        if self.rules:
            from . import slo as slolib

            values.update(slolib.rule_history_samples(
                self.rules, registry=self._reg))
        if self._fleet is not None:
            try:
                merged = self._fleet.view().get("metrics", {})
            except Exception:  # pragma: no cover — scrape races at shutdown
                merged = {}
            for key, stats in merged.items():
                for stat in FLEET_STATS:
                    v = stats.get(stat)
                    if isinstance(v, (int, float)):
                        values[f"fleet.{_flat_name(key)}.{stat}"] = float(v)
        return {
            k: float(v) for k, v in values.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
            and math.isfinite(v)
        }

    def tick(self, now: float | None = None) -> dict[str, float]:
        """One sampling pass: append every surface's current value to its
        ring and (with a logdir) one row to history.jsonl.  Returns the
        sampled values (tests)."""
        now = self._time() if now is None else float(now)
        values = self._collect()
        kept: dict[str, float] = {}
        with self._lock:
            reserved = len(self._pinned - set(self._series))
            for name, v in values.items():
                s = self._series.get(name)
                if s is None:
                    # hard memory bound: a cardinality bug upstream must
                    # not grow this process without limit.  Pinned names
                    # (alert-rule metrics) have reserved slots so a
                    # late-appearing watched series is never the one the
                    # cap evicts; the total still never exceeds
                    # max_series.
                    if name in self._pinned:
                        reserved -= 1
                    elif len(self._series) + reserved >= self.max_series:
                        self._dropped.add(name)
                        continue
                    if len(self._series) >= self.max_series:
                        self._dropped.add(name)
                        continue
                    s = self._series[name] = _Series(
                        self.points_per_series, self.interval_s)
                s.add(now, v)
                kept[name] = v
            self.ticks += 1
        with self._log_lock:
            if self._hist_log is not None:
                # full resolution on disk (the ring alone downsamples);
                # only tracked series ride the row, so per-row cardinality
                # stays <= max_series (the schema checker's bound)
                self._hist_log.write(json.dumps(
                    {"t": now, "values": kept}) + "\n")
                self._hist_log.flush()
        return kept

    def pin(self, names) -> "MetricsHistory":
        """Reserve capacity for these series names: pinned series are
        admitted even after unpinned cardinality has filled the cap
        (unpinned series can only claim ``max_series`` minus the not-yet-
        materialized pinned count).  The alert manager pins every rule's
        watched metric so offline replay over ``history.jsonl`` sees the
        exact series the live rules evaluated."""
        with self._lock:
            self._pinned.update(str(n) for n in names if n)
        return self

    # -- queries -------------------------------------------------------------

    def series_names(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def query(self, metric: str, window_s: float = 300.0,
              now: float | None = None) -> dict | None:
        """In-window points for one series (None for an unknown name)."""
        now = self._time() if now is None else float(now)
        window_s = max(float(window_s), 0.0)
        with self._lock:
            s = self._series.get(metric)
            if s is None:
                return None
            cutoff = now - window_s
            pts = [(t, v) for t, v in s.points if t >= cutoff]
            res = s.res_s
            span = (s.points[-1][0] - s.points[0][0]) if s.points else 0.0
        return {
            "metric": metric,
            "window_s": window_s,
            "res_s": res,
            "span_s": round(span, 3),
            "n": len(pts),
            "points": [[round(t, 3), v] for t, v in pts],
            "latest": pts[-1][1] if pts else None,
        }

    def state(self) -> dict:
        with self._lock:
            return {
                "interval_s": self.interval_s,
                "points_per_series": self.points_per_series,
                "max_series": self.max_series,
                "series": len(self._series),
                "series_dropped": len(self._dropped),
                "series_pinned": len(self._pinned),
                "ticks": self.ticks,
            }

    def histz(self, query: str = "") -> tuple[int, object]:
        """``GET /histz`` handler (StatusServer extra-route shape):
        ``?metric=&window=`` → windowed points; no ``metric`` → the
        series listing plus store state."""
        from urllib.parse import parse_qs

        params = parse_qs(query or "", keep_blank_values=True)
        metric = params.get("metric", [""])[0]
        if not metric:
            return 200, {**self.state(), "names": self.series_names()}
        window = params.get("window", ["300"])[0]
        try:
            window_s = float(window)
            if not math.isfinite(window_s) or window_s <= 0:
                raise ValueError(window)
        except ValueError:
            return 400, {"error": f"bad 'window': {window!r} "
                                  "(seconds, a positive number)"}
        result = self.query(metric, window_s)
        if result is None:
            return 404, {"error": f"unknown metric {metric!r}",
                         "names": self.series_names()}
        return 200, result

    def install(self, server) -> "MetricsHistory":
        """Register ``GET /histz`` on a :class:`obs.server.StatusServer`."""
        server.routes[("GET", "/histz")] = self.histz
        return self

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "MetricsHistory":
        if self._thread is None:
            self._stop.clear()
            self.tick()  # an immediate first sample: short runs still
            self._thread = threading.Thread(  # leave >= 1 history row
                target=self._loop, name="dtf-metrics-history", daemon=True
            )
            self._thread.start()
            logger.info(
                "metrics history: sampling every %.1fs "
                "(<= %d series x %d points)",
                self.interval_s, self.max_series, self.points_per_series,
            )
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # pragma: no cover - belt and braces
                logger.exception("metrics history tick failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        try:
            self.tick()  # final snapshot so the last window is on disk
        except Exception:  # pragma: no cover
            logger.exception("metrics history final tick failed")
        with self._log_lock:
            if self._hist_log is not None:
                self._hist_log.close()
                self._hist_log = None

    def __enter__(self) -> "MetricsHistory":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
