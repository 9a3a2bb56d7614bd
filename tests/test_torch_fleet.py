"""The port's fleet plane (``obs/fleet.py``) against the JAX package's.

``parse_prometheus`` reads the port's own ``/varz`` text (the Prometheus
page of the port's ``StatusServer`` over a registry a numpy seed writes)
to the same samples in both packages, and refuses the same malformed
pages; ``merge_samples`` merges the same peers to the same view; both
packages' ``FleetAggregator`` scrape the same two port status servers to
the same merged metrics, peer states and straggler verdict, flip a
stopped peer to ``down`` within one round, and write a ``fleet.json``
that the schema checker accepts.
"""

import numpy as np
import pytest

from distributedtensorflow_tpu.net import breaker as jax_breaker
from distributedtensorflow_tpu.obs import fleet as jax_fleet
from distributedtensorflow_tpu.obs import registry as jax_registry
from distributedtensorflow_tpu_torch.net import breaker
from distributedtensorflow_tpu_torch.obs import StatusServer, fleet, registry
from tools import check_metrics_schema


@pytest.fixture(autouse=True)
def _breakers():
    for br in (breaker, jax_breaker):
        br.reset_breakers()
    yield
    for br in (breaker, jax_breaker):
        br.reset_breakers()


def _registry(seed, batches):
    """A port registry with counters, labelled gauges and a histogram
    written from ``seed``."""
    rng = np.random.default_rng(seed)
    reg = registry.Registry()
    reg.counter("data_batches_total").inc(batches)
    reg.gauge("steps_per_sec").set(float(rng.uniform(1, 2)))
    reg.gauge("goodput_fraction").set(float(rng.uniform(0.5, 1)))
    for i in range(3):
        reg.gauge("queue_depth", "q").set(float(rng.integers(0, 9)),
                                          tenant=f"t{i}")
    for v in rng.exponential(0.2, 16):
        reg.histogram("serve_ttft_seconds").observe(float(v))
    reg.gauge("odd").set(float("nan"))
    return reg


def test_parse_prometheus_reads_the_port_varz_as_jax():
    page = _registry(0, 10).to_prometheus()
    got = fleet.parse_prometheus(page)
    assert got.keys() == jax_fleet.parse_prometheus(page).keys()
    assert {k: v for k, v in got.items() if v == v} == {
        k: v for k, v in jax_fleet.parse_prometheus(page).items() if v == v}
    assert got["data_batches_total"] == 10.0
    assert got['queue_depth{tenant="t1"}'] >= 0.0


@pytest.mark.parametrize("page", ["ok 1\nbad line here\n",
                                  "x{a=\"1\"} notanumber\n",
                                  "{} 3\n"])
def test_parse_prometheus_refuses_as_jax(page):
    errors = []
    for mod in (fleet, jax_fleet):
        with pytest.raises(mod.FleetScrapeError) as e:
            mod.parse_prometheus(page)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


MERGE_CASES = {
    "empty": {},
    "one": {"a": {"x": 1.0, "y": 2.0}},
    "three": {"a": {"x": 1.0, "y": 2.0}, "b": {"x": 5.0},
              "c": {"x": 3.0, "y": float("inf"), "z": float("nan")}},
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_samples_matches_jax(case):
    samples = MERGE_CASES[case]
    assert fleet.merge_samples(samples) == jax_fleet.merge_samples(samples)


def test_aggregators_scrape_port_servers_as_jax(tmp_path):
    """Two port status servers, one a straggler on data_batches_total:
    both packages' aggregators merge the same view; stopping a peer
    flips it to down on the next round; fleet.json passes the schema
    checker."""
    servers = [StatusServer(0, registry=_registry(s, b)).start()
               for s, b in ((1, 100), (2, 10))]
    try:
        aggs = {}
        for name, mod, reglib in (("torch", fleet, registry),
                                  ("jax", jax_fleet, jax_registry)):
            agg = mod.FleetAggregator(interval_s=1.0, timeout_s=2.0,
                                      logdir=str(tmp_path / name),
                                      registry=reglib.Registry())
            for i, srv in enumerate(servers):
                agg.add_peer(f"w{i}", f"127.0.0.1:{srv.port}")
            aggs[name] = agg
        views = {name: agg.scrape_once() for name, agg in aggs.items()}
        assert views["torch"]["metrics"] == views["jax"]["metrics"]
        assert views["torch"]["states"] == views["jax"]["states"] == \
            {"up": 2, "stale": 0, "down": 0}
        assert views["torch"]["worst_spread"] == views["jax"]["worst_spread"]
        assert views["torch"]["worst_spread"]["peer"] == "w0"
        servers[1].stop()
        views = {name: agg.scrape_once() for name, agg in aggs.items()}
        for view in views.values():
            assert view["peers"]["w1"]["state"] == "down"
        assert views["torch"]["metrics"] == views["jax"]["metrics"]
        status, text = aggs["torch"].fleetz("metric=data_batches")
        assert status == 200 and "1 up" in text and "1 down" in text
        assert check_metrics_schema.main(
            [str(tmp_path / "torch" / "fleet.json")]) == 0
    finally:
        for srv in servers:
            srv.stop()
