"""The port's metrics history store (``obs/tsdb.py``) and
``UsageMeter.attach_history`` against the JAX package's.

Each scenario runs twice, once through each package's modules, on the
same registry writes made from a numpy seed and the same injected clock:
``_flat_name`` over a list of keys, the downsampling ring, ticks and
windowed queries, the series cap with pins, the ``/histz`` status codes,
``history.jsonl`` (equal rows; the schema checker accepts them) and the
tenants' pinned usage series.  Exact equality throughout: the modules
are framework-free and do the same float arithmetic.
"""

import numpy as np
import pytest

from distributedtensorflow_tpu.obs import registry as jax_registry
from distributedtensorflow_tpu.obs import tsdb as jax_tsdb
from distributedtensorflow_tpu.obs import usage as jax_usage
from distributedtensorflow_tpu_torch.obs import registry, tsdb, usage
from tools import check_metrics_schema

PACKAGES = {"jax": (jax_registry, jax_tsdb), "torch": (registry, tsdb)}

#: Keys as a fleet merge delivers them (Prometheus label braces).
FLAT_KEYS = [
    "step",
    'breaker_state{endpoint="fleet_peer:chief"}',
    'data_wait_seconds_bucket{le="+Inf"}',
    'serve_tenant_tokens_total{tenant="a-b.c"}',
    'slo_burn_rate{slo="serve_ttft_p99",window="fast"}',
    "odd{}",
    'x{a="1",b="two words"}',
]


class Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.mark.parametrize("key", FLAT_KEYS)
def test_flat_name_matches_jax(key):
    assert tsdb._flat_name(key) == jax_tsdb._flat_name(key)


def test_series_ring_matches_jax():
    """The same point stream through both rings: the same decimated
    points and resolution."""
    rng = np.random.default_rng(0)
    ts = np.cumsum(rng.uniform(0.0, 2.0, 200))
    vs = rng.normal(size=200)
    rings = [mod._Series(16, 1.0) for mod in (jax_tsdb, tsdb)]
    for t, v in zip(ts, vs):
        for ring in rings:
            ring.add(float(t), float(v))
    assert list(rings[0].points) == list(rings[1].points)
    assert rings[0].res_s == rings[1].res_s > 1.0


def _scripted(pkg, logdir=None, **kw):
    """Both packages' history over a registry that a numpy seed writes;
    ``(history, kept dicts of each tick)``."""
    reglib, tsdblib = PACKAGES[pkg]
    reg = reglib.Registry()
    clock = Clock()
    hist = tsdblib.MetricsHistory(registry=reg, time_fn=clock, logdir=logdir,
                                  interval_s=1.0, points_per_series=8, **kw)
    rng = np.random.default_rng(7)
    kept = []
    for i in range(30):
        reg.gauge("queue_depth").set(float(rng.integers(0, 9)))
        reg.counter("requests_total").inc(int(rng.integers(1, 4)))
        reg.histogram("lat_seconds").observe(float(rng.uniform(0, 2)))
        if i >= 10:
            reg.gauge("late").set(float(i))
        if i == 20:
            reg.gauge("bad").set(float("nan"))
        clock.t += float(rng.uniform(0.5, 1.5))
        kept.append(hist.tick())
    return hist, kept


def test_ticks_and_queries_match_jax(tmp_path):
    hists, kepts = {}, {}
    for pkg in PACKAGES:
        hists[pkg], kepts[pkg] = _scripted(pkg, logdir=str(tmp_path / pkg))
        hists[pkg].stop()
    assert kepts["jax"] == kepts["torch"]
    assert hists["jax"].state() == hists["torch"].state()
    assert hists["jax"].series_names() == hists["torch"].series_names()
    for name in hists["jax"].series_names():
        for window in (3.0, 10.0, 300.0):
            assert hists["jax"].query(name, window) == \
                hists["torch"].query(name, window)
    rows = {pkg: (tmp_path / pkg / "history.jsonl").read_text()
            for pkg in PACKAGES}
    assert rows["jax"] == rows["torch"]
    assert check_metrics_schema.main(
        [str(tmp_path / "torch" / "history.jsonl")]) == 0


def test_series_cap_and_pins_match_jax():
    """A cap of 3 with one pinned late name: the same kept series and
    the same drops in both."""
    out = {}
    for pkg, (reglib, tsdblib) in PACKAGES.items():
        reg = reglib.Registry()
        hist = tsdblib.MetricsHistory(registry=reg, max_series=3,
                                      time_fn=Clock())
        hist.pin(["watched"])
        for i in range(5):
            reg.gauge(f"g{i}").set(float(i))
        first = hist.tick()
        reg.gauge("watched").set(9.0)
        second = hist.tick()
        out[pkg] = (first, second, hist.state(), hist.series_names())
    assert out["jax"] == out["torch"]
    assert "watched" in out["torch"][1]


HISTZ_QUERIES = ("", "metric=queue_depth&window=5",
                 "metric=queue_depth&window=abc", "metric=queue_depth&"
                 "window=-5", "metric=missing", "metric=lat_seconds_sum")


@pytest.mark.parametrize("query", HISTZ_QUERIES)
def test_histz_matches_jax(query):
    got = {pkg: _scripted(pkg)[0].histz(query) for pkg in PACKAGES}
    assert got["jax"] == got["torch"]


def test_histz_route_on_the_port_status_server():
    from distributedtensorflow_tpu_torch.obs import StatusServer

    reg = registry.Registry()
    reg.gauge("depth").set(1.0)
    srv = StatusServer(0, registry=reg)
    hist = tsdb.MetricsHistory(registry=reg, time_fn=Clock()).install(srv)
    hist.tick()
    status, body = srv.route("GET", "/histz")("metric=depth&window=60")
    assert status == 200 and body["latest"] == 1.0


class _Req:
    def __init__(self, rid, tenant):
        self.id, self.tenant = rid, tenant
        self.t_submit, self.t_admit, self.prefill_tokens = 0.0, 0.5, 8


def test_usage_attach_history_pins_as_jax():
    """Tenants metered before and after ``attach_history`` are pinned,
    the same names in both packages."""
    pinned = {}
    for pkg, meter_mod, tsdblib, reglib in (
            ("jax", jax_usage, jax_tsdb, jax_registry),
            ("torch", usage, tsdb, registry)):
        reg = reglib.Registry()
        meter = meter_mod.UsageMeter(registry=reg, device_kind="")
        hist = tsdblib.MetricsHistory(registry=reg, time_fn=Clock())
        meter.on_admit(_Req("r0", "a"))
        meter.attach_history(hist)
        meter.on_admit(_Req("r1", "b"))
        pinned[pkg] = sorted(hist._pinned)
    assert pinned["jax"] == pinned["torch"]
    assert "serve_tenant_tokens_total.tenant_b" in pinned["torch"]
    assert "serve_tenant_tokens_per_s.tenant_a" in pinned["torch"]
