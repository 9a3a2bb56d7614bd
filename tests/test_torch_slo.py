"""The port's SLO monitor (``obs/slo.py``) against the JAX package's.

The same rule documents load to the same rules (``examples/slo_rules.json``
among them) and the same bad documents give the same error lists; the
same latency observations and gauge writes, made from a numpy seed and
evaluated at the same injected times, give the same burn rates,
violations, ``slo_violation`` flight events and ``slo_burn`` capture
requests; ``recompute_from_history`` gives the same offline burns from
the same ``history.jsonl``-shaped rows; ``/sloz`` renders the same text.
Exact equality: the modules are framework-free.
"""

import json
import os

import numpy as np
import pytest

from distributedtensorflow_tpu.obs import flight_recorder as jax_flight
from distributedtensorflow_tpu.obs import registry as jax_registry
from distributedtensorflow_tpu.obs import slo as jax_slo
from distributedtensorflow_tpu_torch.obs import flight_recorder, registry, slo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": (jax_registry, jax_slo, jax_flight),
            "torch": (registry, slo, flight_recorder)}


def _latency_rule(**kw):
    base = dict(
        name="e2e_p99", kind="histogram_under", metric="serve_e2e_seconds",
        threshold=0.25, objective=0.9, fast_window_s=10.0,
        slow_window_s=60.0, fast_burn=5.0, slow_burn=2.0,
    )
    base.update(kw)
    return base


GAUGE_RULES = [
    {"name": "goodput", "kind": "gauge_good_fraction",
     "metric": "goodput_fraction", "objective": 0.7,
     "fast_window_s": 10, "slow_window_s": 60,
     "fast_burn": 2.0, "slow_burn": 1.5},
    {"name": "data_wait", "kind": "gauge_bad_fraction",
     "metric": "data_wait_share", "objective": 0.8,
     "fast_window_s": 10, "slow_window_s": 60,
     "fast_burn": 2.0, "slow_burn": 1.5},
]

BAD_DOCS = {
    "kind": {"slos": [_latency_rule(kind="nope")]},
    "objective_one": {"slos": [_latency_rule(objective=1.0)]},
    "objective_negative": [_latency_rule(objective=-0.1)],
    "threshold_zero": {"slos": [_latency_rule(threshold=0)]},
    "windows_swapped": {"slos": [_latency_rule(fast_window_s=100.0,
                                               slow_window_s=10.0)]},
    "burn_zero": {"slos": [_latency_rule(fast_burn=0)]},
    "empty_name": {"slos": [{"name": "", "kind": "histogram_under",
                             "metric": "m", "objective": 0.5,
                             "threshold": 1.0}]},
    "gauge_threshold": {"slos": [dict(GAUGE_RULES[0], threshold=1.0)]},
    "duplicate": {"slos": [_latency_rule(), _latency_rule()]},
    "no_slos": {"nope": 1},
    "not_a_doc": "text",
    "not_an_object": {"slos": [3]},
}


def test_example_rules_load_as_jax():
    path = os.path.join(REPO, "examples", "slo_rules.json")
    got = [r.to_dict() for r in slo.load_rules(path)]
    assert got == [r.to_dict() for r in jax_slo.load_rules(path)]
    assert len(got) == 3


@pytest.mark.parametrize("case", sorted(BAD_DOCS))
def test_validate_rules_doc_same_errors(case, tmp_path):
    doc = BAD_DOCS[case]
    errors = slo.validate_rules_doc(doc)
    assert errors and errors == jax_slo.validate_rules_doc(doc)
    path = tmp_path / "rules.json"
    path.write_text(json.dumps(doc))
    assert _load_error(slo, path) == _load_error(jax_slo, path)


def _load_error(mod, path) -> str:
    with pytest.raises(ValueError) as e:
        mod.load_rules(str(path))
    return str(e.value)


class _Capture:
    def __init__(self):
        self.requests = []

    def request(self, trigger, **kw):
        self.requests.append((trigger, kw))
        return True, "armed"


def _scripted(pkg):
    """A latency rule and two gauge rules over seeded traffic, evaluated
    at the same times: ``(results by pass, flight events, capture
    requests, registry scalars, /sloz text, monitor)``."""
    reglib, slolib, frlib = PACKAGES[pkg]
    reg = reglib.Registry()
    flight = frlib.FlightRecorder(capacity=64)
    prev = frlib.install_recorder(flight)
    cap = _Capture()
    try:
        mon = slolib.SLOMonitor([_latency_rule(), *GAUGE_RULES],
                                registry=reg, interval_s=1.0,
                                capture_engine=cap)
        h = reg.histogram("serve_e2e_seconds")
        rng = np.random.default_rng(3)
        out = [mon.evaluate(now=1000.0)]
        for i in range(12):
            # healthy, then a burst of slow requests, then recovery
            scale = 1.0 if 4 <= i < 8 else 0.05
            for v in rng.exponential(scale, 8):
                h.observe(float(v))
            reg.gauge("goodput_fraction").set(float(rng.uniform(0, 1)))
            reg.gauge("data_wait_share").set(float(rng.uniform(0, 0.5)))
            out.append(mon.evaluate(now=1001.0 + 3 * i))
        events = [{k: v for k, v in e.items() if k not in ("t", "seq")}
                  for e in flight.events() if e["kind"] == "slo_violation"]
        return (out, events, cap.requests, reg.scalars(), mon.sloz("")[1],
                mon)
    finally:
        frlib.install_recorder(prev)


def test_burn_rates_violations_and_captures_match_jax():
    got, want = _scripted("torch"), _scripted("jax")
    assert got[0] == want[0]
    assert got[1] == want[1] and got[1]
    assert got[2] == want[2] and got[2][0][0] == "slo_burn"
    assert got[3] == want[3]
    assert got[4] == want[4]
    assert got[5].sloz("json") == (200, got[5].state())


def test_recompute_from_history_matches_jax():
    """Offline burns from the same seeded history rows, on both
    planes' math, at several evaluation times."""
    rng = np.random.default_rng(11)
    rows, good, total = [], 0.0, 0.0
    for i in range(40):
        n = float(rng.integers(1, 20))
        total += n
        good += float(rng.binomial(int(n), 0.85))
        rows.append({"t": 500.0 + 2.5 * i, "values": {
            "slo_good.e2e_p99": good, "slo_total.e2e_p99": total,
            "slo_good.goodput": float(rng.uniform(0.3, 1.0)),
            "slo_good.data_wait": float(rng.uniform(0.5, 1.0)),
        }})
    rows.insert(7, "not a row")
    rules = [_latency_rule(), *GAUGE_RULES]
    for now in (None, 540.0, 560.0, 1000.0):
        got = slo.recompute_from_history(rules, rows, now=now)
        assert got == jax_slo.recompute_from_history(rules, rows, now=now)
    assert any(not r.get("no_data_fast") for r in got)


def test_rule_history_samples_match_jax():
    out = {}
    for pkg, (reglib, slolib, _) in PACKAGES.items():
        reg = reglib.Registry()
        for v in (0.1, 0.2, 0.3, 3.0):
            reg.histogram("serve_e2e_seconds").observe(v)
        reg.gauge("goodput_fraction").set(0.8)
        reg.gauge("data_wait_share", "labeled only").set(0.5, rank="0")
        out[pkg] = slolib.rule_history_samples(
            [_latency_rule(), *GAUGE_RULES], registry=reg)
    assert out["torch"] == out["jax"]
    assert "slo_good.data_wait" not in out["torch"]
