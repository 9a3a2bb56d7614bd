"""SLO burn-rate monitor: declarative objectives over registry metrics.

Twin of ``distributedtensorflow_tpu/obs/slo.py``, framework-free and
copied whole: it reads the port's registry, records into the port's
flight recorder and arms the port's ``CaptureEngine``.

The serving stack exports SLO *histograms* (``serve_ttft_seconds``,
``serve_e2e_seconds``), the goodput ledger exports a *fraction* gauge,
and the input plane exports wait histograms — but nothing watches them.
This module closes the loop: declarative JSON rules are evaluated over
the live registry on a background thread, each reduced to a windowed
**good fraction** ``g`` against an **objective** ``o`` (the target good
fraction), and alerting follows the standard multi-window burn-rate
policy:

    ``burn = (1 - g) / (1 - o)``

i.e. how many times faster than budget the error budget is burning
(burn 1.0 = exactly on budget).  Each rule carries a *fast* window
(paging: a sharp breach trips it in minutes) and a *slow* window
(ticketing: a simmering breach), each with its own burn threshold — the
Google SRE-workbook multi-window multi-burn-rate shape, scaled to
in-process evaluation.

Rule kinds (``kind``):

- ``histogram_under`` — ``metric`` is a registry histogram; good events
  are observations ``<= threshold`` (seconds).  Windowing is by event
  count: burn is computed from the delta of (good, total) between the
  window's edges.  Serve TTFT/e2e latency SLOs are this kind.
- ``gauge_good_fraction`` — ``metric`` is a gauge already holding the
  good fraction in [0, 1] (``goodput_fraction``).  Windowed by the mean
  of samples inside the window.
- ``gauge_bad_fraction`` — the gauge holds the BAD fraction (a data-wait
  share of step time); good = 1 - value.

Rule file schema (validated by ``tools/check_metrics_schema.py``)::

    {"slos": [{"name": "serve_e2e_p99", "kind": "histogram_under",
               "metric": "serve_e2e_seconds", "threshold": 2.5,
               "objective": 0.99,
               "fast_window_s": 60, "slow_window_s": 600,
               "fast_burn": 14.4, "slow_burn": 6.0}, ...]}

Outputs per evaluation: ``slo_burn_rate{slo=,window=fast|slow}`` gauges
(non-negative by construction), ``slo_violations_total{slo=}`` counters,
an edge-triggered ``slo_violation`` flight event per (rule, window)
breach, a ``GET /sloz`` endpoint (text + ``?json``), and — when a
``capture_engine`` is attached — a ``slo_burn``-triggered reactive
profiler capture on a fast-burn trip, so an SLO breach auto-profiles
itself (the reactive-profiling loop closed at fleet level).

A rule whose metric has no data yet evaluates to burn 0 with
``no_data: true`` — absence of traffic is not a breach.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import math
import threading
import time

from . import registry as reglib
from .flight_recorder import record_event

logger = logging.getLogger(__name__)

__all__ = [
    "RULE_KINDS",
    "SLO_WINDOWS",
    "SLORule",
    "SLOMonitor",
    "load_rules",
    "validate_rules_doc",
    "rule_history_samples",
    "recompute_from_history",
]

RULE_KINDS = ("histogram_under", "gauge_good_fraction", "gauge_bad_fraction")
SLO_WINDOWS = ("fast", "slow")


@dataclasses.dataclass(frozen=True)
class SLORule:
    """One declarative SLO (see the module docstring for semantics)."""

    name: str
    kind: str
    metric: str
    objective: float
    threshold: float | None = None
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    fast_burn: float = 14.4
    slow_burn: float = 6.0

    @staticmethod
    def from_dict(raw: dict) -> "SLORule":
        errors = _validate_rule(raw, "rule")
        if errors:
            raise ValueError("; ".join(errors))
        return SLORule(
            name=str(raw["name"]),
            kind=str(raw["kind"]),
            metric=str(raw["metric"]),
            objective=float(raw["objective"]),
            threshold=(float(raw["threshold"])
                       if raw.get("threshold") is not None else None),
            fast_window_s=float(raw.get("fast_window_s", 60.0)),
            slow_window_s=float(raw.get("slow_window_s", 600.0)),
            fast_burn=float(raw.get("fast_burn", 14.4)),
            slow_burn=float(raw.get("slow_burn", 6.0)),
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


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
    if kind not in RULE_KINDS:
        errors.append(f"{where}: 'kind' {kind!r} not in {RULE_KINDS}")
    metric = raw.get("metric")
    if not isinstance(metric, str) or not metric:
        errors.append(f"{where}: 'metric' {metric!r} is not a non-empty "
                      "string")
    obj = raw.get("objective")
    if not _num(obj) or not 0.0 <= obj < 1.0:
        errors.append(f"{where}: 'objective' {obj!r} must be a finite "
                      "number in [0, 1)")
    thr = raw.get("threshold")
    if kind == "histogram_under":
        if not _num(thr) or thr <= 0:
            errors.append(f"{where}: 'threshold' {thr!r} must be a positive "
                          "finite number for histogram_under")
    elif thr is not None:
        errors.append(f"{where}: 'threshold' is only valid for "
                      "histogram_under rules")
    fast_w = raw.get("fast_window_s", 60.0)
    slow_w = raw.get("slow_window_s", 600.0)
    for label, v in (("fast_window_s", fast_w), ("slow_window_s", slow_w)):
        if not _num(v) or v <= 0:
            errors.append(f"{where}: {label!r} {v!r} must be a positive "
                          "finite number")
    if _num(fast_w) and _num(slow_w) and fast_w > slow_w:
        errors.append(f"{where}: fast_window_s {fast_w} exceeds "
                      f"slow_window_s {slow_w}")
    for label in ("fast_burn", "slow_burn"):
        v = raw.get(label, 1.0)
        if not _num(v) or v <= 0:
            errors.append(f"{where}: {label!r} {v!r} must be a positive "
                          "finite number (burn-rate thresholds)")
    return errors


def validate_rules_doc(doc) -> list[str]:
    """Errors in a parsed rule document (``{"slos": [...]}`` or a bare
    list).  Shared with ``tools/check_metrics_schema.py`` semantics but
    importable — the tool duplicates the checks stdlib-only."""
    if isinstance(doc, dict):
        rules = doc.get("slos")
        if not isinstance(rules, list):
            return ["'slos' is missing or not a list"]
    elif isinstance(doc, list):
        rules = doc
    else:
        return [f"document is {type(doc).__name__}, not an object or list"]
    errors: list[str] = []
    seen: set[str] = set()
    for i, raw in enumerate(rules):
        where = f"slos[{i}]"
        errors.extend(_validate_rule(raw, where))
        name = raw.get("name") if isinstance(raw, dict) else None
        if isinstance(name, str) and name:
            if name in seen:
                errors.append(f"{where}: duplicate rule name {name!r}")
            seen.add(name)
    return errors


def load_rules(path: str) -> list[SLORule]:
    """Parse + validate a rule file; raises ``ValueError`` with every
    violation listed (fail at startup, not mid-run)."""
    with open(path) as f:
        doc = json.load(f)
    errors = validate_rules_doc(doc)
    if errors:
        raise ValueError(f"{path}: " + "; ".join(errors))
    rules = doc["slos"] if isinstance(doc, dict) else doc
    return [SLORule.from_dict(r) for r in rules]


def _rule_sample(rule: SLORule, reg) -> tuple | None:
    """One instantaneous sample for ``rule`` from the registry, or None
    for no data: ``(good, total)`` cumulative counts for histogram rules,
    ``(good_fraction,)`` for gauge rules.  READ-ONLY lookup: get-or-create
    would register the name with the observer's kind and crash the real
    producer's later registration with a kind mismatch."""
    m = reg.get(rule.metric)
    if rule.kind == "histogram_under":
        if not isinstance(m, reglib.Histogram):
            return None
        return (m.count_under(rule.threshold), m.total_count())
    if not isinstance(m, reglib.Gauge):
        return None
    items = dict(m._items())
    if () not in items:
        # No UNLABELED sample: either never written, or a labeled-only
        # gauge — reading value() would return the 0.0 default and fire
        # a false maximum-burn violation.  Gauge rules target the
        # unlabeled series; no data.
        return None
    value = items[()]
    if not math.isfinite(value):
        return None
    good = value if rule.kind == "gauge_good_fraction" else 1.0 - value
    return (min(max(good, 0.0), 1.0),)


def _window_good(rule: SLORule, samples, window_s: float,
                 now: float) -> float | None:
    """Good fraction over the trailing window from a sample deque
    (``(t, good, total)`` snapshots for histogram rules, ``(t, good)``
    for gauge rules), or None for no data.  Shared between the live
    monitor and :func:`recompute_from_history` so offline burns use the
    exact same math."""
    if not samples:
        return None
    cutoff = now - window_s
    if rule.kind == "histogram_under":
        cur = samples[-1]
        # reference = the newest snapshot at or before the window edge
        # (covers the full window); fall back to the oldest we have.
        ref = samples[0]
        for s in samples:
            if s[0] <= cutoff:
                ref = s
            else:
                break
        d_total = cur[2] - ref[2]
        if d_total <= 0:
            return None  # no traffic in the window
        d_good = max(min(cur[1] - ref[1], d_total), 0.0)
        return d_good / d_total
    vals = [s[1] for s in samples if s[0] >= cutoff]
    if not vals:
        vals = [samples[-1][1]]
    return sum(vals) / len(vals)


def _burn(good: float, objective: float) -> float:
    budget = 1.0 - objective
    return max((1.0 - good) / budget, 0.0) if budget > 0 else 0.0


def rule_history_samples(rules, registry=None) -> dict[str, float]:
    """Per-rule good/total snapshot scalars for the history store
    (``obs.tsdb``): ``slo_good.<name>`` (+ ``slo_total.<name>`` for
    histogram rules) per rule with data.  Persisted into history.jsonl
    ticks, these are exactly the samples :func:`recompute_from_history`
    needs to rebuild burn rates offline."""
    reg = registry or reglib.default_registry()
    out: dict[str, float] = {}
    for rule in rules:
        rule = rule if isinstance(rule, SLORule) else SLORule.from_dict(rule)
        s = _rule_sample(rule, reg)
        if s is None:
            continue
        out[f"slo_good.{rule.name}"] = float(s[0])
        if len(s) > 1:
            out[f"slo_total.{rule.name}"] = float(s[1])
    return out


def recompute_from_history(rules, rows, now: float | None = None) -> list[dict]:
    """Offline SLO burn recomputation from ``history.jsonl`` rows
    (each ``{"t": ..., "values": {...}}``, as written by
    ``obs.tsdb.MetricsHistory``).  Replays each rule's
    ``slo_good.<name>`` / ``slo_total.<name>`` series through the same
    windowed-good math the live monitor uses and returns per-rule result
    dicts shaped like :meth:`SLOMonitor.evaluate`'s (burn/good/no_data
    per window), evaluated at ``now`` (default: the newest row time)."""
    rules = [r if isinstance(r, SLORule) else SLORule.from_dict(r)
             for r in rules]
    samples: dict[str, collections.deque] = {
        r.name: collections.deque() for r in rules
    }
    last_t = None
    for row in rows:
        if not isinstance(row, dict):
            continue
        t = row.get("t")
        vals = row.get("values")
        if not _num(t) or not isinstance(vals, dict):
            continue
        last_t = t if last_t is None else max(last_t, t)
        for rule in rules:
            g = vals.get(f"slo_good.{rule.name}")
            if not _num(g):
                continue
            if rule.kind == "histogram_under":
                tot = vals.get(f"slo_total.{rule.name}")
                if not _num(tot):
                    continue
                samples[rule.name].append((float(t), float(g), float(tot)))
            else:
                samples[rule.name].append((float(t), float(g)))
    if now is None:
        now = last_t
    results: list[dict] = []
    for rule in rules:
        result: dict = {
            "name": rule.name,
            "kind": rule.kind,
            "metric": rule.metric,
            "objective": rule.objective,
        }
        for window, window_s in (("fast", rule.fast_window_s),
                                 ("slow", rule.slow_window_s)):
            good = None if now is None else _window_good(
                rule, samples[rule.name], window_s, now)
            if good is None:
                result[f"burn_{window}"] = 0.0
                result[f"no_data_{window}"] = True
            else:
                result[f"good_{window}"] = good
                result[f"burn_{window}"] = _burn(good, rule.objective)
        results.append(result)
    return results


class _RuleState:
    __slots__ = ("rule", "samples", "active", "violations", "last")

    def __init__(self, rule: SLORule):
        self.rule = rule
        #: (t, good, total) snapshots for histogram rules; (t, good_value)
        #: samples for gauge rules.  Bounded by the slow window at prune.
        self.samples: collections.deque = collections.deque()
        self.active: set[str] = set()  # windows currently in violation
        self.violations = 0
        self.last: dict = {}


class SLOMonitor:
    """Evaluate a set of :class:`SLORule`s over the registry on a
    background thread (or synchronously via :meth:`evaluate` — tests).

    ``capture_engine`` (an ``obs.capture.CaptureEngine``) arms a
    ``slo_burn`` capture on every fast-window violation edge."""

    def __init__(
        self,
        rules,
        *,
        registry=None,
        interval_s: float = 5.0,
        capture_engine=None,
        time_fn=time.time,
    ):
        self.rules = [
            r if isinstance(r, SLORule) else SLORule.from_dict(r)
            for r in rules
        ]
        self.interval_s = max(float(interval_s), 0.05)
        self._time = time_fn
        self._capture = capture_engine
        self._reg = registry or reglib.default_registry()
        self._states = {r.name: _RuleState(r) for r in self.rules}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._m_burn = self._reg.gauge(
            "slo_burn_rate", "error-budget burn rate by slo and window"
        )
        self._m_violations = self._reg.counter(
            "slo_violations_total", "slo burn-rate threshold trips by slo"
        )

    # -- sampling ------------------------------------------------------------

    def _sample(self, st: _RuleState, now: float) -> None:
        rule = st.rule
        s = _rule_sample(rule, self._reg)
        if s is None:
            # absent or differently-kinded metric (or a non-finite /
            # labeled-only gauge): simply no data
            return
        if rule.kind == "histogram_under":
            st.samples.append((now, s[0], s[1]))
        else:
            st.samples.append((now, s[0]))
        horizon = now - st.rule.slow_window_s - self.interval_s
        while len(st.samples) > 1 and st.samples[0][0] < horizon:
            st.samples.popleft()

    def _window_good(self, st: _RuleState, window_s: float,
                     now: float) -> float | None:
        """Good fraction over the trailing window, or None for no data."""
        return _window_good(st.rule, st.samples, window_s, now)

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, now: float | None = None) -> list[dict]:
        """One evaluation pass: sample every rule, compute fast/slow burn
        rates, export gauges, fire edge-triggered violations.  Returns the
        per-rule results (also kept for /sloz)."""
        now = self._time() if now is None else float(now)
        results: list[dict] = []
        with self._lock:
            states = list(self._states.values())
        for st in states:
            rule = st.rule
            self._sample(st, now)
            result: dict = {
                "name": rule.name,
                "kind": rule.kind,
                "metric": rule.metric,
                "objective": rule.objective,
            }
            newly: list[tuple[str, float, float]] = []
            for window, window_s, limit in (
                ("fast", rule.fast_window_s, rule.fast_burn),
                ("slow", rule.slow_window_s, rule.slow_burn),
            ):
                good = self._window_good(st, window_s, now)
                if good is None:
                    burn = 0.0
                    result[f"no_data_{window}"] = True
                else:
                    burn = _burn(good, rule.objective)
                    result[f"good_{window}"] = good
                result[f"burn_{window}"] = burn
                self._m_burn.set(burn, slo=rule.name, window=window)
                violating = good is not None and burn > limit
                result[f"violating_{window}"] = violating
                if violating and window not in st.active:
                    st.active.add(window)
                    st.violations += 1
                    newly.append((window, burn, limit))
                elif not violating:
                    st.active.discard(window)
            result["violations"] = st.violations
            st.last = result
            results.append(result)
            for window, burn, limit in newly:
                self._m_violations.inc(slo=rule.name)
                logger.error(
                    "SLO VIOLATION: %s %s-window burn %.2fx exceeds %.2fx "
                    "(objective %.4g on %s)",
                    rule.name, window, burn, limit, rule.objective,
                    rule.metric,
                )
                record_event(
                    "slo_violation", slo=rule.name, window=window,
                    burn=round(burn, 4), limit=limit,
                    objective=rule.objective, metric=rule.metric,
                )
                if window == "fast" and self._capture is not None:
                    # An SLO breach auto-profiles itself: arm the reactive
                    # profiler on the fast-burn trip (budget/cooldown
                    # refusals are normal on repeat trips).
                    self._capture.request(
                        "slo_burn",
                        reason=f"slo {rule.name} fast burn {burn:.2f}x "
                               f"(> {limit:g}x)",
                    )
        return results

    # -- read ----------------------------------------------------------------

    def state(self) -> dict:
        with self._lock:
            return {
                "interval_s": self.interval_s,
                "rules": [
                    dict(st.last) or {"name": st.rule.name,
                                      "pending": True}
                    for st in self._states.values()
                ],
                "violations_total": sum(
                    st.violations for st in self._states.values()
                ),
            }

    def _render_text(self) -> str:
        state = self.state()
        lines = [
            f"slo: {len(state['rules'])} rule(s), "
            f"{state['violations_total']} violation(s) "
            f"(evaluated every {state['interval_s']:g}s)",
        ]
        for r in state["rules"]:
            if r.get("pending"):
                lines.append(f"  {r['name']}: not yet evaluated")
                continue
            flags = []
            for w in SLO_WINDOWS:
                mark = ""
                if r.get(f"violating_{w}"):
                    mark = "  ** BURNING **"
                elif r.get(f"no_data_{w}"):
                    mark = " (no data)"
                flags.append(f"{w} {r.get(f'burn_{w}', 0.0):.2f}x{mark}")
            lines.append(
                f"  {r['name']} [{r['kind']} on {r['metric']}, "
                f"objective {r['objective']:g}]: " + ", ".join(flags)
                + (f"  violations {r['violations']}"
                   if r.get("violations") else "")
            )
        return "\n".join(lines) + "\n"

    def sloz(self, query: str = "") -> tuple[int, object]:
        """``GET /sloz`` handler (StatusServer extra-route shape)."""
        from urllib.parse import parse_qs

        params = parse_qs(query or "", keep_blank_values=True)
        if "json" in params or params.get("format") == ["json"]:
            return 200, self.state()
        return 200, self._render_text()

    def install(self, server) -> "SLOMonitor":
        """Register ``GET /sloz`` on a :class:`obs.server.StatusServer`."""
        server.routes[("GET", "/sloz")] = self.sloz
        return self

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "SLOMonitor":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="dtf-slo-monitor", daemon=True
            )
            self._thread.start()
            logger.info(
                "slo monitor: %d rule(s) evaluated every %.1fs",
                len(self.rules), self.interval_s,
            )
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.evaluate()
            except Exception:  # pragma: no cover - belt and braces
                logger.exception("slo evaluation failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "SLOMonitor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
