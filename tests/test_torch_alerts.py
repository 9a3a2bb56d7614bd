"""The port's alert manager (``obs/alerts.py``) against the JAX package's.

The same rule documents (``examples/alert_rules.json`` among them) load
to the same rules and the same bad documents give the same errors; the
same sequence of registry samples, made from a numpy seed and evaluated
under one injected clock, gives the same fired/resolved transitions of
threshold, prefix, absence, anomaly and burn rules (with a cooldown and a
silence), the same ``alerts.jsonl``, the same incident manifests and the
same ``/alertz`` text; ``recompute_from_history`` replays the same rows
to the same transitions; the webhook sink delivers every transition to
an in-thread loopback receiver; the deep-health components give the same
verdicts, the engine component reading the port frontend's ``draining``.
"""

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from distributedtensorflow_tpu.obs import alerts as jax_alerts
from distributedtensorflow_tpu.obs import registry as jax_registry
from distributedtensorflow_tpu.obs import slo as jax_slo
from distributedtensorflow_tpu.obs import tsdb as jax_tsdb
from distributedtensorflow_tpu_torch.net import breaker
from distributedtensorflow_tpu_torch.obs import alerts, registry, slo, tsdb
from tools import check_metrics_schema

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": (jax_registry, jax_alerts, jax_slo, jax_tsdb),
            "torch": (registry, alerts, slo, tsdb)}


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


RULES = [
    {"name": "hot", "kind": "threshold", "metric": "temp", "op": "gt",
     "bound": 10.0, "agg": "avg", "window_s": 6.0, "cooldown_s": 8.0,
     "severity": "page"},
    {"name": "cold", "kind": "threshold", "metric": "temp", "op": "lt",
     "bound": 0.5, "agg": "min", "window_s": 4.0, "cooldown_s": 0.0},
    {"name": "retries", "kind": "threshold", "metric": "rpc_retries_total",
     "match": "prefix", "op": "gt", "bound": 5.0, "cooldown_s": 0.0},
    {"name": "stall", "kind": "absence", "metric": "steps", "for_s": 5.0,
     "cooldown_s": 0.0, "severity": "page"},
    {"name": "spike", "kind": "anomaly", "metric": "rss", "window_s": 60.0,
     "z_threshold": 4.0, "min_history": 6, "cooldown_s": 0.0,
     "severity": "info"},
    {"name": "ttft_burn", "kind": "burn", "slo": "ttft", "window": "fast",
     "cooldown_s": 0.0},
    {"name": "never", "kind": "threshold", "metric": "missing",
     "op": "gt", "bound": 0.0},
]
SLO_RULES = [{"name": "ttft", "kind": "histogram_under",
              "metric": "serve_ttft_seconds", "threshold": 0.5,
              "objective": 0.9, "fast_window_s": 6.0,
              "slow_window_s": 60.0, "fast_burn": 2.0, "slow_burn": 1.5}]

BAD_DOCS = {
    "kind": {"alerts": [{"name": "a", "kind": "nope"}]},
    "severity": {"alerts": [dict(RULES[0], severity="loud")]},
    "source": {"alerts": [dict(RULES[0], source="nowhere")]},
    "prefix_history": {"alerts": [dict(RULES[2], source="history")]},
    "no_bound": {"alerts": [{"name": "a", "kind": "threshold",
                             "metric": "m"}]},
    "no_slo": {"alerts": [{"name": "b", "kind": "burn"}]},
    "for_s": {"alerts": [dict(RULES[3], for_s=0)]},
    "min_history": [dict(RULES[4], min_history=1)],
    "labels": {"alerts": [dict(RULES[0], labels={"a": 1})]},
    "duplicate": {"alerts": [RULES[0], RULES[0]]},
    "no_alerts": {"slos": []},
    "not_a_doc": 7,
}


def test_example_rules_load_as_jax():
    path = os.path.join(REPO, "examples", "alert_rules.json")
    got = [r.to_dict() for r in alerts.load_rules(path)]
    assert got == [r.to_dict() for r in jax_alerts.load_rules(path)]
    assert any(r["metric"] == "dynamics_global_grad_norm" for r in got)


def _load_error(mod, path) -> str:
    with pytest.raises(ValueError) as e:
        mod.load_rules(str(path))
    return str(e.value)


@pytest.mark.parametrize("case", sorted(BAD_DOCS))
def test_validate_rules_doc_same_errors(case, tmp_path):
    doc = BAD_DOCS[case]
    errors = alerts.validate_rules_doc(doc)
    assert errors and errors == jax_alerts.validate_rules_doc(doc)
    path = tmp_path / "rules.json"
    path.write_text(json.dumps(doc))
    assert _load_error(alerts, path) == _load_error(jax_alerts, path)


def _scripted(pkg, logdir):
    """Seeded samples into a registry, one evaluation every 2 s of the
    injected clock: ``(manager, per-pass results)``."""
    reglib, alertlib, slolib, tsdblib = PACKAGES[pkg]
    reg = reglib.Registry()
    clock = Clock()
    mon = slolib.SLOMonitor(SLO_RULES, registry=reg, time_fn=clock)
    hist = tsdblib.MetricsHistory(registry=reg, time_fn=clock)
    mgr = alertlib.AlertManager(
        RULES, registry=reg, interval_s=1.0, logdir=logdir, history=hist,
        slo_monitor=mon, sinks=[], record_flight=True, time_fn=clock)
    rng = np.random.default_rng(21)
    results, steps = [], 0
    for i in range(40):
        clock.t = 1000.0 + 2.0 * i
        reg.gauge("temp").set(float(20.0 if 8 <= i < 14 else
                                    rng.uniform(1.0, 5.0)))
        if i < 25:
            steps += 1
        reg.gauge("steps").set(float(steps))
        reg.gauge("rss").set(float(1e9 + rng.normal(0, 1e6)
                                   + (5e8 if i == 30 else 0.0)))
        reg.counter("rpc_retries_total").inc(
            int(rng.integers(0, 2)), endpoint="peer:a")
        for v in rng.exponential(2.0 if 15 <= i < 20 else 0.05, 4):
            reg.histogram("serve_ttft_seconds").observe(float(v))
        if i == 16:
            mgr.silence("cold", 10.0, reason="test")
        mon.evaluate()
        hist.tick()
        results.append(mgr.evaluate())
    return mgr, results


def test_transitions_match_jax_under_one_clock(tmp_path):
    got_mgr, got = _scripted("torch", str(tmp_path / "torch"))
    want_mgr, want = _scripted("jax", str(tmp_path / "jax"))
    assert got == want
    rows = list(got_mgr.recent)
    assert rows == list(want_mgr.recent)
    fired = {r["rule"] for r in rows if r["phase"] == "fired"}
    assert {"hot", "retries", "spike", "ttft_burn", "stall"} <= fired
    for mgr in (got_mgr, want_mgr):
        mgr.stop()
    text = {pkg: (tmp_path / pkg / "alerts.jsonl").read_text()
            for pkg in ("torch", "jax")}
    assert text["torch"] == text["jax"]
    assert got_mgr.alertz("")[1] == want_mgr.alertz("")[1]
    incidents = sorted(os.listdir(tmp_path / "torch" / "incidents"))
    assert incidents == sorted(os.listdir(tmp_path / "jax" / "incidents"))
    for name in incidents:
        manifests = [json.loads((tmp_path / pkg / "incidents" / name /
                                 "manifest.json").read_text())
                     for pkg in ("torch", "jax")]
        assert manifests[0] == manifests[1]
    assert check_metrics_schema.main(
        [str(tmp_path / "torch" / "alerts.jsonl")]) == 0


def test_recompute_from_history_matches_jax():
    rng = np.random.default_rng(4)
    rows, steps = [], 0.0
    good = total = 0.0
    for i in range(30):
        if i < 20:
            steps += 1
        n = float(rng.integers(1, 10))
        total += n
        good += n if not 10 <= i < 14 else 0.0
        rows.append({"t": 1000.0 + 2.0 * i, "values": {
            "temp": float(25.0 if 10 <= i < 16 else rng.uniform(1, 5)),
            "steps": steps, "rss": float(rng.normal(1e9, 1e6)),
            "slo_good.ttft": good, "slo_total.ttft": total}})
    rules = [dict(r, source="history") if r["kind"] in ("absence",
                                                        "anomaly")
             else r for r in RULES if r.get("match") != "prefix"]
    got = alerts.recompute_from_history(rules, rows, slo_rules=SLO_RULES)
    assert got == jax_alerts.recompute_from_history(rules, rows,
                                                    slo_rules=SLO_RULES)
    assert {r["rule"] for r in got} >= {"hot", "stall", "ttft_burn"}


class _Hook(BaseHTTPRequestHandler):
    rows: list = []

    def do_POST(self):  # noqa: N802 - http.server contract
        body = self.rfile.read(int(self.headers["Content-Length"]))
        type(self).rows.append(json.loads(body))
        self.send_response(200)
        self.end_headers()
        self.wfile.write(b"ok")

    def log_message(self, *args):
        pass


def test_webhook_sink_delivers_transitions_as_jax():
    """Fired and resolved rows of a threshold rule reach a loopback
    receiver from each package's webhook sink; the rows are equal."""
    breaker.reset_breakers()
    handler = type("Hook", (_Hook,), {"rows": []})
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/alerts"
    try:
        delivered = {}
        for pkg, (reglib, alertlib, _, _) in PACKAGES.items():
            handler.rows = []
            reg, clock = reglib.Registry(), Clock()
            mgr = alertlib.AlertManager(
                [RULES[0]], registry=reg, time_fn=clock, record_flight=False,
                sinks=[alertlib.make_webhook_sink(url)])
            for i, temp in enumerate((1.0, 30.0, 30.0, 1.0, 1.0, 1.0)):
                clock.t = 1000.0 + 3.0 * i
                reg.gauge("temp").set(temp)
                mgr.evaluate()
            delivered[pkg] = list(handler.rows)
            assert sum(v for k, v in reg.scalars().items()
                       if k.startswith("alert_sink_errors_total")) == 0
        assert [r["phase"] for r in delivered["torch"]] == \
            ["fired", "resolved"]
        assert delivered["torch"] == delivered["jax"]
    finally:
        srv.shutdown()
        srv.server_close()


class _Engine:
    def __init__(self, clock, busy, age):
        self.clock, self.busy, self.age = clock, busy, age

    def state(self):
        return {"queue_depth": 2 if self.busy else 0, "active_slots": 0}

    def step_records(self, n=None):
        return [{"t": self.clock.t - self.age}]


@pytest.mark.parametrize("busy,age,draining", [(False, 100.0, False),
                                               (True, 100.0, False),
                                               (True, 1.0, False),
                                               (False, 1.0, True)])
def test_deep_health_components_match_jax(busy, age, draining):
    """The engine component reads the port frontend's ``draining``
    property (an unstarted ``ServeServer``); the composed verdicts
    match JAX's."""
    from distributedtensorflow_tpu_torch.serve import ServeServer

    clock = Clock()
    engine = _Engine(clock, busy, age)
    server = ServeServer(engine, 0)
    if draining:
        server.begin_drain()
    assert server.draining is draining

    class _Slo:
        def state(self):
            return {"rules": [{"name": "a", "violating_fast": busy}]}

    class _Fleet:
        def view(self):
            return {"peers": {"w0": {"state": "up"},
                              "w1": {"state": "down" if busy else "up"}}}

    verdicts = []
    for lib in (alerts, jax_alerts):
        verdicts.append(lib.compose_deep_health({
            "engine": lib.engine_health_component(
                engine, server, stall_after_s=30.0, time_fn=clock),
            "slo": lib.slo_health_component(_Slo()),
            "fleet": lib.fleet_health_component(_Fleet()),
            "broken": lambda: 1 / 0,
        })())
    server.stop()  # never started: closes the socket
    assert verdicts[0] == verdicts[1]
    assert "broken" in verdicts[0]["failing"]
    assert verdicts[0]["components"]["engine"]["ok"] is \
        (not (busy and age > 30.0) and not draining)


@pytest.mark.parametrize("goodput", [None, 0.1198, 0.9])
def test_deep_health_of_a_training_run_matches_jax(goodput):
    """``train.py``'s composition (alerts, SLO, fleet) over the example
    rules, on a registry that holds no serving traffic and perhaps a
    ``goodput_fraction`` gauge left by an earlier run in the process (a
    whole ``chip_smoke.py`` run leaves its trainer phase's 0.1198): both
    packages give the same verdict, and only the goodput SLO's fast burn,
    (1 - 0.1198) / 0.3 = 2.93 > 2.0, fails it."""
    with open(os.path.join(REPO, "examples", "slo_rules.json")) as f:
        slo_rules = json.load(f)["slos"]
    alert_path = os.path.join(REPO, "examples", "alert_rules.json")

    class _Fleet:
        def view(self):
            return {"peers": {"chief": {"state": "up"}}, "metrics": {}}

    verdicts = []
    for pkg in ("torch", "jax"):
        reglib, alertlib, slolib, tsdblib = PACKAGES[pkg]
        reg = reglib.Registry()
        reg.counter("data_batches_total").inc(8)
        if goodput is not None:
            reg.gauge("goodput_fraction").set(goodput)
        clock = Clock()
        mon = slolib.SLOMonitor(slo_rules, registry=reg, time_fn=clock)
        hist = tsdblib.MetricsHistory(registry=reg, time_fn=clock)
        mgr = alertlib.AlertManager(
            alertlib.load_rules(alert_path), registry=reg, history=hist,
            fleet=_Fleet(), slo_monitor=mon, sinks=[], record_flight=False,
            time_fn=clock)
        for _ in range(4):
            clock.t += 0.5
            mon.evaluate()
            hist.tick()
            mgr.evaluate()
        verdicts.append(alertlib.compose_deep_health({
            "alerts": mgr.health_component,
            "slo": alertlib.slo_health_component(mon),
            "fleet": alertlib.fleet_health_component(_Fleet()),
        })())
    assert verdicts[0] == verdicts[1]
    burning = ["goodput_fraction"] if goodput is not None \
        and goodput < 0.4 else []
    assert verdicts[0]["components"]["slo"]["fast_burning"] == burning
    assert verdicts[0]["failing"] == (["slo"] if burning else [])
    assert verdicts[0]["ok"] is not burning
