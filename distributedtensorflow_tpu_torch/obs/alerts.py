"""Fleet alerting: declarative alert rules, sinks, incident bundles.

Twin of ``distributedtensorflow_tpu/obs/alerts.py``, framework-free and
copied whole: the port's registry, flight recorder, history store, SLO
monitor, fleet aggregator, ``net.rpc`` and stack dumper.

The observability plane below this module is deep but mute — metrics,
traces, flight events, goodput, SLO burn rates, the engine step log and
the ``MetricsHistory`` store all terminate in a file a human must read
after the fact.  This module closes the loop: declarative JSON alert
rules are evaluated on a background thread over three sources, every
firing fans out to pluggable sinks, and a firing alert snapshots its own
evidence bundle so the debugging artifact exists even if the process
dies seconds later.

Sources (``source``):

- ``registry`` (default) — the live registry's flat scalar snapshot
  (:meth:`obs.registry.Registry.scalars`; labeled series appear under
  their ``name.label_value`` flat spelling);
- ``history`` — the newest ticked value of a :class:`obs.tsdb.MetricsHistory`
  series (covers the store-only names: ``slo_good.*``, ``fleet.*``);
- ``fleet`` — a fleet-merged ``/fleetz`` sample: ``metric`` is the raw
  sample key, ``stat`` picks the merged statistic (default ``max``).

Rule kinds (``kind``):

- ``threshold`` — the value aggregated over the trailing ``window_s``
  (``agg``: ``last``/``min``/``max``/``avg``) compared against ``bound``
  with ``op`` (``gt``/``lt``).  ``match: "prefix"`` sums every flat
  scalar whose name starts with ``metric`` — the spelling for labeled
  counter families (``rpc_retries_total.*``).
- ``burn`` — delegates to the SLO monitor's multi-window burn state:
  fires while SLO rule ``slo``'s ``window`` (``fast``/``slow``) is
  violating.
- ``absence`` — no progress: fires when the metric's value has not
  CHANGED for ``for_s`` seconds (a stalled step counter, a dead peer's
  frozen scrape), or has never appeared ``for_s`` seconds after the
  manager first looked.  Resolves on the next change.
- ``anomaly`` — the :mod:`obs.anomaly` z-spike generalized to any
  series: fires when the newest value is more than ``z_threshold``
  sigma from the trailing ``window_s`` window's mean (``min_history``
  prior samples required).

Alerts are edge-triggered with per-rule ``cooldown_s``, dedup by
(rule, labels) — one open alert per key, a firing while open is
impossible by construction — and silences
(:meth:`AlertManager.silence`).  Every firing emits an ``alert`` flight
event, ``alerts_total{rule=,severity=}``, one ``alerts.jsonl`` row
(``phase: "fired"``, paired with a ``"resolved"`` row under the same
``id``), fans out to the sinks, and — with a ``logdir`` — writes an
incident evidence bundle ``<logdir>/incidents/<id>-<rule>/``:
``manifest.json`` + the relevant ``/varz`` families, the flight-ring
tail, the triggering series' history window, the engine step-log tail,
and an all-thread stack dump.

Sinks are callables ``sink(row)`` invoked for fired AND resolved rows;
exceptions are swallowed and counted (``alert_sink_errors_total``) — a
sink must never wedge the evaluation loop.  Provided: :func:`log_sink`,
:func:`make_webhook_sink` (``POST`` over ``net.rpc.http_post`` —
deadlines, retries, breaker), :func:`make_capture_sink` (arms an
``alert``-triggered reactive-profiler capture for ``severity: "page"``
firings; auto-attached when ``capture_engine`` is passed).

``GET /alertz`` serves live + recent state (text + ``?json``);
:func:`recompute_from_history` replays the rules over ``history.jsonl``
rows and reproduces the live firings in lockstep (the alerting analogue
of ``obs.slo.recompute_from_history``).

A rule whose metric has no data holds its state (no fire, no resolve,
never a crash) — absence is the one kind for which "no data" IS the
alarm condition.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import math
import os
import threading
import time

from . import registry as reglib
from .anomaly import zscore
from .flight_recorder import record_event
from .tsdb import _flat_name

logger = logging.getLogger(__name__)

__all__ = [
    "ALERT_KINDS",
    "ALERT_PHASES",
    "ALERT_SEVERITIES",
    "ALERT_SOURCES",
    "AlertManager",
    "AlertRule",
    "compose_deep_health",
    "engine_health_component",
    "fleet_health_component",
    "load_rules",
    "log_sink",
    "make_capture_sink",
    "make_webhook_sink",
    "recompute_from_history",
    "slo_health_component",
    "validate_rules_doc",
]

ALERT_KINDS = ("threshold", "burn", "absence", "anomaly")
ALERT_SEVERITIES = ("info", "warn", "page")
ALERT_SOURCES = ("registry", "history", "fleet")
ALERT_PHASES = ("fired", "resolved")
THRESHOLD_OPS = ("gt", "lt")
THRESHOLD_AGGS = ("last", "min", "max", "avg")
FLEET_RULE_STATS = ("min", "median", "max", "sum")
BURN_WINDOWS = ("fast", "slow")


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One declarative alert (see the module docstring for semantics)."""

    name: str
    kind: str
    severity: str = "warn"
    metric: str = ""
    source: str = "registry"
    match: str = "exact"          # "exact" | "prefix" (prefix sums)
    stat: str = "max"             # fleet-merged statistic (source=fleet)
    labels: dict = dataclasses.field(default_factory=dict)
    # threshold
    op: str = "gt"
    bound: float | None = None
    window_s: float = 60.0
    agg: str = "last"
    # burn
    slo: str = ""
    window: str = "fast"
    # absence
    for_s: float | None = None
    # anomaly
    z_threshold: float = 6.0
    min_history: int = 8
    # lifecycle
    cooldown_s: float = 60.0

    @staticmethod
    def from_dict(raw: dict) -> "AlertRule":
        errors = _validate_rule(raw, "rule")
        if errors:
            raise ValueError("; ".join(errors))
        return AlertRule(
            name=str(raw["name"]),
            kind=str(raw["kind"]),
            severity=str(raw.get("severity", "warn")),
            metric=str(raw.get("metric", "")),
            source=str(raw.get("source", "registry")),
            match=str(raw.get("match", "exact")),
            stat=str(raw.get("stat", "max")),
            labels=dict(raw.get("labels") or {}),
            op=str(raw.get("op", "gt")),
            bound=(float(raw["bound"])
                   if raw.get("bound") is not None else None),
            window_s=float(raw.get("window_s", 60.0)),
            agg=str(raw.get("agg", "last")),
            slo=str(raw.get("slo", "")),
            window=str(raw.get("window", "fast")),
            for_s=(float(raw["for_s"])
                   if raw.get("for_s") is not None else None),
            z_threshold=float(raw.get("z_threshold", 6.0)),
            min_history=int(raw.get("min_history", 8)),
            cooldown_s=float(raw.get("cooldown_s", 60.0)),
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def label_key(self) -> tuple:
        return tuple(sorted((str(k), str(v))
                            for k, v in self.labels.items()))


def _num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool) \
        and math.isfinite(v)


def _validate_rule(raw, where: str) -> list[str]:
    errors: list[str] = []
    if not isinstance(raw, dict):
        return [f"{where}: not an object"]
    name = raw.get("name")
    if not isinstance(name, str) or not name:
        errors.append(f"{where}: 'name' {name!r} is not a non-empty string")
    kind = raw.get("kind")
    if kind not in ALERT_KINDS:
        errors.append(f"{where}: 'kind' {kind!r} not in {ALERT_KINDS}")
    sev = raw.get("severity", "warn")
    if sev not in ALERT_SEVERITIES:
        errors.append(f"{where}: 'severity' {sev!r} not in "
                      f"{ALERT_SEVERITIES}")
    source = raw.get("source", "registry")
    if source not in ALERT_SOURCES:
        errors.append(f"{where}: 'source' {source!r} not in {ALERT_SOURCES}")
    match = raw.get("match", "exact")
    if match not in ("exact", "prefix"):
        errors.append(f"{where}: 'match' {match!r} not in "
                      "('exact', 'prefix')")
    elif match == "prefix" and source == "history":
        errors.append(f"{where}: 'match: prefix' is not supported for the "
                      "history source (exact series names only)")
    if raw.get("stat", "max") not in FLEET_RULE_STATS:
        errors.append(f"{where}: 'stat' {raw.get('stat')!r} not in "
                      f"{FLEET_RULE_STATS}")
    labels = raw.get("labels", {})
    if not isinstance(labels, dict) or not all(
        isinstance(k, str) and isinstance(v, str) for k, v in labels.items()
    ):
        errors.append(f"{where}: 'labels' must be a string->string object")
    cooldown = raw.get("cooldown_s", 60.0)
    if not _num(cooldown) or cooldown < 0:
        errors.append(f"{where}: 'cooldown_s' {cooldown!r} must be a "
                      "non-negative finite number")
    metric = raw.get("metric", "")
    needs_metric = kind in ("threshold", "absence", "anomaly")
    if needs_metric and (not isinstance(metric, str) or not metric):
        errors.append(f"{where}: 'metric' {metric!r} is not a non-empty "
                      f"string (required for {kind} rules)")
    if kind == "threshold":
        if raw.get("op", "gt") not in THRESHOLD_OPS:
            errors.append(f"{where}: 'op' {raw.get('op')!r} not in "
                          f"{THRESHOLD_OPS}")
        if not _num(raw.get("bound")):
            errors.append(f"{where}: 'bound' {raw.get('bound')!r} must be "
                          "a finite number")
        if raw.get("agg", "last") not in THRESHOLD_AGGS:
            errors.append(f"{where}: 'agg' {raw.get('agg')!r} not in "
                          f"{THRESHOLD_AGGS}")
    elif kind == "burn":
        slo = raw.get("slo")
        if not isinstance(slo, str) or not slo:
            errors.append(f"{where}: 'slo' {slo!r} is not a non-empty "
                          "string (the SLO rule a burn alert delegates to)")
        if raw.get("window", "fast") not in BURN_WINDOWS:
            errors.append(f"{where}: 'window' {raw.get('window')!r} not in "
                          f"{BURN_WINDOWS}")
    elif kind == "absence":
        for_s = raw.get("for_s")
        if not _num(for_s) or for_s <= 0:
            errors.append(f"{where}: 'for_s' {for_s!r} must be a positive "
                          "finite number (seconds of silence)")
    elif kind == "anomaly":
        z = raw.get("z_threshold", 6.0)
        if not _num(z) or z <= 0:
            errors.append(f"{where}: 'z_threshold' {z!r} must be a "
                          "positive finite number")
        mh = raw.get("min_history", 8)
        if isinstance(mh, bool) or not isinstance(mh, int) or mh < 2:
            errors.append(f"{where}: 'min_history' {mh!r} must be an "
                          "int >= 2")
    if kind in ("threshold", "anomaly"):
        w = raw.get("window_s", 60.0)
        if not _num(w) or w <= 0:
            errors.append(f"{where}: 'window_s' {w!r} must be a positive "
                          "finite number")
    return errors


def validate_rules_doc(doc) -> list[str]:
    """Errors in a parsed rule document (``{"alerts": [...]}`` or a bare
    list).  Mirrored stdlib-only by ``tools/check_metrics_schema.py``."""
    if isinstance(doc, dict):
        rules = doc.get("alerts")
        if not isinstance(rules, list):
            return ["'alerts' is missing or not a list"]
    elif isinstance(doc, list):
        rules = doc
    else:
        return [f"document is {type(doc).__name__}, not an object or list"]
    errors: list[str] = []
    seen: set[str] = set()
    for i, raw in enumerate(rules):
        where = f"alerts[{i}]"
        errors.extend(_validate_rule(raw, where))
        name = raw.get("name") if isinstance(raw, dict) else None
        if isinstance(name, str) and name:
            if name in seen:
                errors.append(f"{where}: duplicate rule name {name!r}")
            seen.add(name)
    return errors


def load_rules(path: str) -> list[AlertRule]:
    """Parse + validate an alert rule file; raises ``ValueError`` listing
    every violation (fail at startup, not mid-run)."""
    with open(path) as f:
        doc = json.load(f)
    errors = validate_rules_doc(doc)
    if errors:
        raise ValueError(f"{path}: " + "; ".join(errors))
    rules = doc["alerts"] if isinstance(doc, dict) else doc
    return [AlertRule.from_dict(r) for r in rules]


# --- sinks -------------------------------------------------------------------


def log_sink(row: dict) -> None:
    """Route alert rows into the process log (severity-mapped level)."""
    level = {"info": logging.INFO, "warn": logging.WARNING,
             "page": logging.ERROR}.get(row.get("severity"), logging.WARNING)
    if row.get("phase") == "resolved":
        level = logging.INFO
    logger.log(level, "ALERT %s: %s [%s/%s] value=%s %s",
               row.get("phase"), row.get("rule"), row.get("severity"),
               row.get("kind"), row.get("value"), row.get("reason", ""))


def make_webhook_sink(url: str, *, deadline_s: float = 5.0,
                      policy=None):
    """A ``POST`` webhook sink riding :func:`net.rpc.http_post` — per-row
    deadline, bounded retries, and the endpoint's circuit breaker, so a
    dead receiver costs at most ``deadline_s`` per row and then fails
    fast until the half-open probe re-closes the breaker.  Transport
    errors raise out of the sink (the manager's fan-out counts and
    swallows them)."""
    from ..net import rpc as netrpc

    hostport = url[len("http://"):].partition("/")[0] \
        if url.startswith("http://") else url
    endpoint = f"webhook:{hostport}"

    def sink(row: dict) -> None:
        netrpc.http_post(
            url, row, deadline_s=deadline_s, endpoint=endpoint,
            policy=policy if policy is not None else netrpc.RetryPolicy(
                deadline_s=deadline_s, max_attempts=3,
                backoff_base_s=0.05, backoff_max_s=0.5,
            ),
        )

    sink.__name__ = f"webhook:{hostport}"
    return sink


def make_capture_sink(engine):
    """Arm an ``alert``-triggered reactive-profiler capture on every
    ``severity: "page"`` firing (budget/cooldown refusals are normal on
    repeat trips)."""

    def sink(row: dict) -> None:
        if row.get("phase") == "fired" and row.get("severity") == "page":
            engine.request(
                "alert",
                reason=f"alert {row.get('rule')} fired "
                       f"(value={row.get('value')})",
            )

    sink.__name__ = "capture"
    return sink


# --- per-rule evaluation state ----------------------------------------------


class _RuleState:
    __slots__ = ("rule", "samples", "last_v", "last_change_t",
                 "first_eval_t", "open", "open_id", "fires",
                 "last_fire_t", "last")

    def __init__(self, rule: AlertRule):
        self.rule = rule
        self.samples: collections.deque = collections.deque()  # (t, v)
        self.last_v: float | None = None
        self.last_change_t: float | None = None
        self.first_eval_t: float | None = None
        self.open = False
        self.open_id: int | None = None
        self.fires = 0
        self.last_fire_t: float | None = None
        self.last: dict = {}

    def horizon_s(self) -> float:
        r = self.rule
        spans = [r.window_s]
        if r.for_s is not None:
            spans.append(r.for_s)
        return max(spans)


def _agg_value(agg: str, vals: list[float]) -> float:
    if agg == "min":
        return min(vals)
    if agg == "max":
        return max(vals)
    if agg == "avg":
        return sum(vals) / len(vals)
    return vals[-1]  # last


class AlertManager:
    """Evaluate :class:`AlertRule`s on a background thread (or
    synchronously via :meth:`evaluate` — tests and offline replay).

    All sources are optional; a rule whose source is not attached simply
    has no data.  ``sinks`` is a list of ``sink(row)`` callables;
    ``capture_engine`` auto-appends :func:`make_capture_sink`;
    ``step_records_fn`` (e.g. ``Engine.step_records``) feeds the incident
    bundles' step-log tail."""

    def __init__(
        self,
        rules,
        *,
        registry=None,
        interval_s: float = 5.0,
        logdir: str | None = None,
        history=None,
        fleet=None,
        slo_monitor=None,
        capture_engine=None,
        sinks=None,
        step_records_fn=None,
        max_incidents: int = 32,
        recent_rows: int = 256,
        record_flight: bool = True,
        time_fn=time.time,
    ):
        self.rules = [
            r if isinstance(r, AlertRule) else AlertRule.from_dict(r)
            for r in rules
        ]
        self.interval_s = max(float(interval_s), 0.05)
        self._reg = registry or reglib.default_registry()
        self._history = history
        if history is not None and hasattr(history, "pin"):
            # reserve history capacity for every exactly-watched metric:
            # offline replay over history.jsonl must see the same series
            # the live rules evaluated, even under the cardinality cap
            history.pin(r.metric for r in self.rules
                        if r.metric and r.match == "exact")
        self._fleet = fleet
        self._slo = slo_monitor
        self._step_records = step_records_fn
        self._record_flight = record_flight
        self._time = time_fn
        self.sinks = list(sinks if sinks is not None else [log_sink])
        if capture_engine is not None:
            self.sinks.append(make_capture_sink(capture_engine))
        self._logdir = logdir
        self._max_incidents = max(int(max_incidents), 0)
        self._incidents_written = 0
        self._states = {r.name: _RuleState(r) for r in self.rules}
        self._silences: list[dict] = []
        self._next_id = 0
        self.recent: collections.deque = collections.deque(
            maxlen=max(int(recent_rows), 1))
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._alerts_log = None
        self._log_lock = threading.Lock()
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            self._alerts_log = open(os.path.join(logdir, "alerts.jsonl"), "a")
        self._m_alerts = self._reg.counter(
            "alerts_total", "alert firings by rule and severity")
        self._m_open = self._reg.gauge(
            "alerts_open", "currently-open (fired, unresolved) alerts")
        self._m_sink_errors = self._reg.counter(
            "alert_sink_errors_total", "alert sink delivery failures by sink")

    # -- silences ------------------------------------------------------------

    def silence(self, rule: str, duration_s: float,
                reason: str = "") -> dict:
        """Suppress NEW firings of ``rule`` (``"*"`` = every rule) for
        ``duration_s`` seconds; open alerts still resolve.  Returns the
        silence record."""
        s = {"rule": str(rule), "until": self._time() + float(duration_s),
             "reason": reason}
        with self._lock:
            self._silences.append(s)
        return s

    def _silenced(self, name: str, now: float) -> bool:
        with self._lock:
            self._silences = [s for s in self._silences if s["until"] > now]
            return any(s["rule"] in ("*", name) for s in self._silences)

    # -- sampling ------------------------------------------------------------

    def _collect(self, now: float) -> dict[str, float]:
        """One flat sample of every attached surface (the same names the
        history store persists, so offline replay sees identical
        inputs)."""
        values = dict(self._reg.scalars())
        if self._fleet is not None:
            try:
                merged = self._fleet.view().get("metrics", {})
            except Exception:  # pragma: no cover — scrape races at shutdown
                merged = {}
            for key, stats in merged.items():
                for stat in FLEET_RULE_STATS:
                    v = stats.get(stat)
                    if isinstance(v, (int, float)):
                        values[f"fleet.{_flat_name(key)}.{stat}"] = float(v)
        return values

    def _rule_value(self, rule: AlertRule, values: dict,
                    now: float) -> float | None:
        if rule.source == "history":
            if values is not None and rule.metric in values:
                # offline replay: the history rows ARE the store
                v = values[rule.metric]
                return float(v) if _num(v) else None
            if self._history is None:
                return None
            q = self._history.query(rule.metric,
                                    window_s=max(rule.window_s, 1.0),
                                    now=now)
            v = q.get("latest") if q else None
            return float(v) if _num(v) else None
        name = rule.metric
        if rule.source == "fleet":
            name = f"fleet.{_flat_name(rule.metric)}.{rule.stat}"
        if rule.match == "prefix":
            vals = [v for k, v in values.items()
                    if k.startswith(name) and _num(v)]
            return float(sum(vals)) if vals else None
        v = values.get(name)
        return float(v) if _num(v) else None

    # -- condition math ------------------------------------------------------

    def _burn_condition(self, rule: AlertRule,
                        now: float) -> tuple[bool | None, float | None, str]:
        """Live burn delegation: the SLO monitor's last evaluation of
        SLO rule ``rule.slo`` on ``rule.window``.  Overridden during
        offline replay."""
        if self._slo is None:
            return None, None, "no slo monitor attached"
        try:
            entries = self._slo.state().get("rules", [])
        except Exception:  # pragma: no cover — belt and braces
            return None, None, "slo monitor state unavailable"
        for r in entries:
            if r.get("name") != rule.slo or r.get("pending"):
                continue
            violating = r.get(f"violating_{rule.window}")
            burn = r.get(f"burn_{rule.window}")
            if violating is None:
                return None, burn, "slo window not evaluated"
            return bool(violating), burn, \
                f"slo {rule.slo} {rule.window} burn {burn}"
        return None, None, f"slo rule {rule.slo!r} unknown"

    def _condition(self, st: _RuleState, value: float | None,
                   now: float) -> tuple[bool | None, float | None, str]:
        """(condition, reported value, reason).  ``condition`` None =
        no data: hold the current state."""
        rule = st.rule
        if rule.kind == "burn":
            return self._burn_condition(rule, now)
        if st.first_eval_t is None:
            st.first_eval_t = now
        if value is not None:
            if st.last_v is None or value != st.last_v:
                st.last_change_t = now
                st.last_v = value
            st.samples.append((now, value))
        horizon = now - st.horizon_s() - self.interval_s
        while len(st.samples) > 1 and st.samples[0][0] < horizon:
            st.samples.popleft()
        if rule.kind == "absence":
            ref = st.last_change_t if st.last_change_t is not None \
                else st.first_eval_t
            silent_s = now - ref
            cond = silent_s >= rule.for_s
            detail = (f"no new value for {silent_s:.1f}s "
                      f"(for_s {rule.for_s:g})" if cond
                      else f"last change {silent_s:.1f}s ago")
            return cond, value if value is not None else st.last_v, detail
        if value is None:
            return None, None, "no data"
        if rule.kind == "threshold":
            cutoff = now - rule.window_s
            vals = [v for t, v in st.samples if t >= cutoff]
            if not vals:
                return None, value, "no data in window"
            agg_v = _agg_value(rule.agg, vals)
            cond = agg_v > rule.bound if rule.op == "gt" \
                else agg_v < rule.bound
            return cond, agg_v, (f"{rule.agg} over {rule.window_s:g}s = "
                                 f"{agg_v:g} {rule.op} {rule.bound:g}")
        # anomaly: newest value vs the trailing window (excluding it)
        cutoff = now - rule.window_s
        prior = [v for t, v in st.samples if t >= cutoff][:-1]
        if len(prior) < rule.min_history:
            return False, value, (f"warming up ({len(prior)}/"
                                  f"{rule.min_history} samples)")
        z = zscore(prior, value)
        cond = z > rule.z_threshold
        return cond, value, f"z={z:.2f} vs threshold {rule.z_threshold:g}"

    # -- emission ------------------------------------------------------------

    def _emit(self, row: dict, rule: AlertRule) -> None:
        self.recent.append(row)
        with self._log_lock:
            if self._alerts_log is not None:
                self._alerts_log.write(json.dumps(row) + "\n")
                self._alerts_log.flush()
        if self._record_flight:
            record_event("alert", rule=row["rule"], severity=row["severity"],
                         alert_id=row["id"], phase=row["phase"],
                         value=row.get("value"))
        if row["phase"] == "fired":
            self._m_alerts.inc(rule=rule.name, severity=rule.severity)
        self._m_open.set(float(sum(
            1 for st in self._states.values() if st.open)))
        for sink in self.sinks:
            try:
                sink(dict(row))
            except Exception as e:
                name = getattr(sink, "__name__", sink.__class__.__name__)
                self._m_sink_errors.inc(sink=name)
                logger.warning("alert sink %s failed for %s/%s: %r",
                               name, rule.name, row["phase"], e)

    def _fire(self, st: _RuleState, now: float, value, reason: str) -> dict:
        rule = st.rule
        with self._lock:
            alert_id = self._next_id
            self._next_id += 1
        st.open = True
        st.open_id = alert_id
        st.fires += 1
        st.last_fire_t = now
        row = {"t": now, "id": alert_id, "rule": rule.name,
               "kind": rule.kind, "severity": rule.severity,
               "phase": "fired", "labels": dict(rule.labels),
               "value": value, "reason": reason}
        self._emit(row, rule)
        if self._record_flight:
            self._write_incident(row, st)
        return row

    def _resolve(self, st: _RuleState, now: float, value, reason: str) -> dict:
        rule = st.rule
        row = {"t": now, "id": st.open_id, "rule": rule.name,
               "kind": rule.kind, "severity": rule.severity,
               "phase": "resolved", "labels": dict(rule.labels),
               "value": value, "reason": reason}
        st.open = False
        st.open_id = None
        self._emit(row, rule)
        return row

    # -- incident evidence bundles -------------------------------------------

    def _write_incident(self, row: dict, st: _RuleState) -> None:
        """Snapshot the firing's context into ``incidents/<id>-<rule>/``.
        Best-effort by design: evidence collection must never take the
        evaluation loop down with it."""
        if not self._logdir or self._incidents_written >= self._max_incidents:
            return
        rule = st.rule
        try:
            d = os.path.join(self._logdir, "incidents",
                             f"{row['id']:04d}-{rule.name}")
            os.makedirs(d, exist_ok=True)
            files: list[str] = []

            def _put(name: str, payload) -> None:
                path = os.path.join(d, name)
                with open(path, "w") as f:
                    if isinstance(payload, str):
                        f.write(payload)
                    else:
                        json.dump(payload, f, indent=1, default=str)
                files.append(name)

            _put("varz.prom", self._relevant_prometheus(rule))
            try:
                from . import flight_recorder as frlib

                rec = frlib.default_recorder()
                if rec is not None:
                    _put("flight.json", rec.events()[-128:])
            except Exception:
                pass
            if self._history is not None and rule.metric:
                metric = rule.metric
                if rule.source == "fleet":
                    metric = f"fleet.{_flat_name(rule.metric)}.{rule.stat}"
                q = self._history.query(metric,
                                        window_s=max(st.horizon_s(), 300.0),
                                        now=row["t"])
                if q is not None:
                    _put("history.json", q)
            if self._step_records is not None:
                try:
                    _put("steps.json", list(self._step_records(64)))
                except TypeError:
                    _put("steps.json", list(self._step_records()))
            try:
                import io

                from ..utils.watchdog import dump_all_stacks

                buf = io.StringIO()
                dump_all_stacks(file=buf)
                _put("threads.txt", buf.getvalue())
            except Exception:
                pass
            manifest = {"id": row["id"], "t": row["t"], "rule": rule.name,
                        "kind": rule.kind, "severity": rule.severity,
                        "labels": dict(rule.labels), "value": row["value"],
                        "reason": row["reason"], "files": sorted(files)}
            tmp = os.path.join(d, f".manifest.tmp.{os.getpid()}")
            with open(tmp, "w") as f:
                json.dump(manifest, f, indent=1)
            os.replace(tmp, os.path.join(d, "manifest.json"))
            self._incidents_written += 1
            logger.info("alert %s: incident bundle %s (%d files)",
                        rule.name, d, len(files))
        except Exception:  # pragma: no cover — never kill the eval loop
            logger.exception("incident bundle for alert %s failed",
                             rule.name)

    def _relevant_prometheus(self, rule: AlertRule) -> str:
        """The ``/varz`` families whose name shares the rule metric's base
        token — the whole page when nothing matches (an empty bundle
        would be worse than a big one)."""
        page = self._reg.to_prometheus()
        base = (rule.metric or rule.slo).split(".")[0].split("{")[0]
        if not base:
            return page
        kept: list[str] = []
        for line in page.splitlines():
            token = line.split()[1] if line.startswith("#") and \
                len(line.split()) > 2 else line.split("{")[0].split(" ")[0]
            if token.startswith(base) or base.startswith(
                    token.rstrip("_bucket_sum_count")):
                kept.append(line)
        return ("\n".join(kept) + "\n") if kept else page

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, now: float | None = None,
                 values: dict | None = None) -> list[dict]:
        """One pass: sample every rule, run the edge-triggered state
        machine, emit fired/resolved rows.  ``values`` overrides the
        collected sample dict (offline replay over history rows)."""
        now = self._time() if now is None else float(now)
        if values is None:
            values = self._collect(now)
        results: list[dict] = []
        for st in self._states.values():
            rule = st.rule
            try:
                value = self._rule_value(rule, values, now)
                cond, reported, reason = self._condition(st, value, now)
            except Exception:  # pragma: no cover — belt and braces
                logger.exception("alert rule %s evaluation failed",
                                 rule.name)
                cond, reported, reason = None, None, "evaluation error"
            suppressed = ""
            if cond is True and not st.open:
                if self._silenced(rule.name, now):
                    suppressed = "silenced"
                elif st.last_fire_t is not None and \
                        now - st.last_fire_t < rule.cooldown_s:
                    suppressed = "cooldown"
                else:
                    self._fire(st, now, reported, reason)
            elif cond is False and st.open:
                self._resolve(st, now, reported, reason)
            st.last = {
                "name": rule.name, "kind": rule.kind,
                "severity": rule.severity, "condition": cond,
                "value": reported, "reason": reason, "open": st.open,
                "fires": st.fires, "suppressed": suppressed,
            }
            results.append(dict(st.last))
        return results

    # -- read ----------------------------------------------------------------

    def open_alerts(self, severity: str | None = None) -> list[dict]:
        out = []
        for st in self._states.values():
            if st.open and (severity is None
                            or st.rule.severity == severity):
                out.append({"rule": st.rule.name, "id": st.open_id,
                            "severity": st.rule.severity,
                            "labels": dict(st.rule.labels)})
        return out

    def state(self) -> dict:
        with self._lock:
            silences = [dict(s) for s in self._silences]
        return {
            "interval_s": self.interval_s,
            "rules": [dict(st.last) or {"name": st.rule.name,
                                        "pending": True}
                      for st in self._states.values()],
            "open": self.open_alerts(),
            "recent": list(self.recent)[-64:],
            "silences": silences,
            "fires_total": sum(st.fires for st in self._states.values()),
            "incidents_written": self._incidents_written,
        }

    def health_component(self) -> tuple[bool, dict]:
        """Deep-health input: failing while any page-severity alert is
        open."""
        pages = self.open_alerts(severity="page")
        return not pages, {"open_page_alerts": pages}

    def _render_text(self) -> str:
        state = self.state()
        lines = [
            f"alerts: {len(state['rules'])} rule(s), "
            f"{len(state['open'])} open, {state['fires_total']} firing(s) "
            f"(evaluated every {state['interval_s']:g}s)",
        ]
        for r in state["rules"]:
            if r.get("pending") or "condition" not in r:
                lines.append(f"  {r['name']}: not yet evaluated")
                continue
            mark = ""
            if r["open"]:
                mark = "  ** FIRING **"
            elif r["condition"] is None:
                mark = " (no data)"
            elif r.get("suppressed"):
                mark = f" ({r['suppressed']})"
            lines.append(
                f"  {r['name']} [{r['kind']}/{r['severity']}]: "
                f"{r.get('reason', '')}{mark}"
                + (f"  fires {r['fires']}" if r.get("fires") else "")
            )
        for s in state["silences"]:
            lines.append(f"  silence: {s['rule']} until {s['until']:.0f} "
                         f"({s.get('reason', '')})")
        return "\n".join(lines) + "\n"

    def alertz(self, query: str = "") -> tuple[int, object]:
        """``GET /alertz`` handler (StatusServer extra-route shape)."""
        from urllib.parse import parse_qs

        params = parse_qs(query or "", keep_blank_values=True)
        if "json" in params or params.get("format") == ["json"]:
            return 200, self.state()
        return 200, self._render_text()

    def install(self, server) -> "AlertManager":
        """Register ``GET /alertz`` on a :class:`obs.server.StatusServer`."""
        server.routes[("GET", "/alertz")] = self.alertz
        return self

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "AlertManager":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="dtf-alert-manager", daemon=True
            )
            self._thread.start()
            logger.info("alert manager: %d rule(s) evaluated every %.1fs",
                        len(self.rules), self.interval_s)
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.evaluate()
            except Exception:  # pragma: no cover - belt and braces
                logger.exception("alert evaluation failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
            try:
                self.evaluate()  # one final pass: resolve rows land on disk
            except Exception:  # pragma: no cover
                logger.exception("final alert evaluation failed")
        with self._log_lock:
            if self._alerts_log is not None:
                self._alerts_log.close()
                self._alerts_log = None

    def __enter__(self) -> "AlertManager":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# --- offline replay ----------------------------------------------------------


def recompute_from_history(rules, rows, *, slo_rules=None) -> list[dict]:
    """Replay alert rules over ``history.jsonl`` rows (each
    ``{"t": ..., "values": {...}}``) and return the alerts.jsonl-shaped
    fired/resolved rows a live manager evaluating at each row's ``t``
    over the same values would have written — the alerting analogue of
    :func:`obs.slo.recompute_from_history`.  ``slo_rules`` (parsed SLO
    rules) back any ``burn`` alert rules: their good/total snapshots ride
    the same rows (``slo_good.<name>`` / ``slo_total.<name>``), replayed
    through the SLO monitor's own windowed-good math."""
    from . import slo as slolib

    slo_rules = [
        r if isinstance(r, slolib.SLORule) else slolib.SLORule.from_dict(r)
        for r in (slo_rules or [])
    ]
    slo_by_name = {r.name: r for r in slo_rules}
    slo_samples: dict[str, collections.deque] = {
        r.name: collections.deque() for r in slo_rules
    }

    mgr = AlertManager(rules, registry=reglib.Registry(), sinks=[],
                       record_flight=False, time_fn=lambda: 0.0)

    def offline_burn(rule: AlertRule, now: float):
        sr = slo_by_name.get(rule.slo)
        if sr is None:
            return None, None, f"slo rule {rule.slo!r} unknown"
        window_s = sr.fast_window_s if rule.window == "fast" \
            else sr.slow_window_s
        limit = sr.fast_burn if rule.window == "fast" else sr.slow_burn
        good = slolib._window_good(sr, slo_samples[sr.name], window_s, now)
        if good is None:
            return None, 0.0, "no data"
        burn = slolib._burn(good, sr.objective)
        return burn > limit, burn, \
            f"slo {rule.slo} {rule.window} burn {burn:.4g}"

    mgr._burn_condition = offline_burn  # type: ignore[method-assign]

    for row in rows:
        if not isinstance(row, dict):
            continue
        t = row.get("t")
        vals = row.get("values")
        if not _num(t) or not isinstance(vals, dict):
            continue
        for sr in slo_rules:
            g = vals.get(f"slo_good.{sr.name}")
            if not _num(g):
                continue
            if sr.kind == "histogram_under":
                tot = vals.get(f"slo_total.{sr.name}")
                if not _num(tot):
                    continue
                slo_samples[sr.name].append((float(t), float(g), float(tot)))
            else:
                slo_samples[sr.name].append((float(t), float(g)))
        mgr.evaluate(now=float(t), values=vals)
    return list(mgr.recent)


# --- deep health --------------------------------------------------------------


def compose_deep_health(components: dict) -> "collections.abc.Callable":
    """Compose per-component probes into one ``/healthz?deep=1`` verdict
    function.  ``components`` maps name -> ``fn() -> (ok, detail_dict)``;
    the verdict is ``{"ok", "failing": [names], "components": {...}}`` —
    a failing probe (or one that raises) names itself, so a router can
    tell a wedged engine from a burning SLO without parsing anything
    else."""

    def verdict() -> dict:
        comps: dict[str, dict] = {}
        failing: list[str] = []
        for name, fn in components.items():
            try:
                ok, detail = fn()
                detail = dict(detail)
            except Exception as e:
                ok, detail = False, {"error": repr(e)}
            detail["ok"] = bool(ok)
            comps[name] = detail
            if not ok:
                failing.append(name)
        return {"ok": not failing, "failing": failing, "components": comps}

    return verdict


def slo_health_component(monitor) -> "collections.abc.Callable":
    """Probe for :func:`compose_deep_health`: failing while any SLO rule
    is fast-burning (slow-window burns warn via alerts, they don't flip
    readiness)."""

    def probe() -> tuple[bool, dict]:
        burning = [
            r.get("name") for r in monitor.state()["rules"]
            if r.get("violating_fast")
        ]
        return not burning, {"fast_burning": burning}

    return probe


def engine_health_component(engine, server=None, *, stall_after_s=30.0,
                            time_fn=time.time) -> "collections.abc.Callable":
    """Probe for :func:`compose_deep_health` (serve only): failing while
    the frontend is draining (not ready for new work) or the engine is
    *stalled* — it has queued/active requests but its step log hasn't
    advanced in ``stall_after_s`` (a wedged dispatch looks exactly like
    this: busy state, silent log)."""

    def probe() -> tuple[bool, dict]:
        st = engine.state()
        busy = st["queue_depth"] > 0 or st["active_slots"] > 0
        recs = engine.step_records(1)
        last_t = recs[-1].get("t") if recs else None
        stalled = bool(
            busy and last_t is not None
            and time_fn() - float(last_t) > stall_after_s
        )
        draining = bool(server.draining) if server is not None else False
        return not (stalled or draining), {
            "draining": draining,
            "stalled": stalled,
            "queue_depth": st["queue_depth"],
            "active_slots": st["active_slots"],
            "last_step_age_s": (
                round(time_fn() - float(last_t), 3)
                if last_t is not None else None
            ),
        }

    return probe


def fleet_health_component(agg) -> "collections.abc.Callable":
    """Probe for :func:`compose_deep_health` (chief only): failing while
    any registered fleet peer is ``down`` — the chief's readiness
    reflects the fleet it coordinates, not just its own process."""

    def probe() -> tuple[bool, dict]:
        peers = agg.view()["peers"]
        down = sorted(n for n, p in peers.items() if p["state"] == "down")
        return not down, {"down_peers": down, "peers": len(peers)}

    return probe
