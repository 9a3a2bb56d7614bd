"""The port's ``obs`` package against the JAX package's, on the same
scripted inputs, and the telemetry of the checkpoint, preemption and
watchdog layers.

Each ported module meets its JAX twin: the registry's ``scalars()`` and
Prometheus text are equal strings; the anomaly detector flags the same
anomalies; a tracer's window totals and ``trace.jsonl`` rows are equal
under one scripted clock; goodput and flight documents from scripted
events are equal under one scripted clock and pass
``tools/check_metrics_schema``; the capture engine's manifest rows are
equal under injected profiler calls; ``host_aggregate`` gives JAX's fields
for one process and the ranks' spread over thread ranks; the memory
record has JAX's CPU keys; ``mfu`` knows the H100 SXM and nothing it does
not know.  Each test installs and uninstalls the singletons it uses, and
the two packages' singletons are separate objects.
"""

import json
import math
import os
import threading
import time

import pytest
import torch

from distributedtensorflow_tpu.obs import anomaly as jax_anomaly
from distributedtensorflow_tpu.obs import capture as jax_capture
from distributedtensorflow_tpu.obs import flight_recorder as jax_flight
from distributedtensorflow_tpu.obs import goodput as jax_goodput
from distributedtensorflow_tpu.obs import memory as jax_memory
from distributedtensorflow_tpu.obs import registry as jax_registry
from distributedtensorflow_tpu.obs import tracing as jax_tracing
from distributedtensorflow_tpu.obs.aggregate import (
    host_aggregate as jax_host_aggregate,
)
from distributedtensorflow_tpu_torch import obs
from distributedtensorflow_tpu_torch import train as tt
from distributedtensorflow_tpu_torch.checkpoint import (
    CheckpointManager,
    PreemptionHandler,
)
from distributedtensorflow_tpu_torch.data import skip_batches
from distributedtensorflow_tpu_torch.obs import (
    anomaly,
    capture,
    flight_recorder,
    goodput,
    memory,
    mfu,
    registry,
    tracing,
)
from distributedtensorflow_tpu_torch.parallel.mesh import MeshSpec, build_mesh
from distributedtensorflow_tpu_torch.testing import run_ranks
from distributedtensorflow_tpu_torch.utils import Watchdog
from tools import check_metrics_schema


class Clock:
    """A scripted clock: each call returns the next tick."""

    def __init__(self, t0=1.7e9, dt=0.25):
        self.t, self.dt = t0, dt
        self.lock = threading.Lock()

    def __call__(self):
        with self.lock:
            self.t += self.dt
            return self.t


@pytest.fixture
def scripted_time(monkeypatch):
    """Both packages' obs modules on scripted clocks, one per package,
    starting at the same tick (``time.time`` and ``time.perf_counter`` of
    each module read its package's clock)."""
    clocks = {}
    for pkg, mods in (("jax", (jax_tracing, jax_goodput, jax_flight,
                               jax_capture)),
                      ("port", (tracing, goodput, flight_recorder,
                                capture))):
        clock = clocks[pkg] = Clock()
        for mod in mods:
            fake = type("time", (), {"time": staticmethod(clock),
                                     "perf_counter": staticmethod(clock),
                                     "monotonic": staticmethod(clock)})
            monkeypatch.setattr(mod, "time", fake)
    return clocks


def _check_file(path):
    errors, _ = check_metrics_schema.check_file(str(path))
    return errors


# -------------------------------------------------------------- registry


def _drive_registry(mod):
    reg = mod.Registry()
    c = reg.counter("requests_total", "requests by code")
    c.inc(code="200")
    c.inc(3, code="500")
    c.inc()
    g = reg.gauge("queue_depth", "queued items")
    g.set(7.5)
    g.set(2, shard="a b")
    h = reg.histogram("step_seconds", "step wall", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 3.0, 30.0, float("inf")):
        h.observe(v)
    h.observe(0.2, kind="eval")
    reg.gauge("nan_gauge").set(float("nan"))
    small = mod.Registry(max_label_sets=2)
    d = small.counter("drops_total")
    for i in range(4):
        d.inc(id=str(i))
    return reg, small


def test_registry_text_equals_jax():
    """The same operations give the same scalars() and Prometheus text,
    the cardinality guard included."""
    got, got_small = _drive_registry(registry)
    ref, ref_small = _drive_registry(jax_registry)
    assert got.to_prometheus() == ref.to_prometheus()
    assert got_small.to_prometheus() == ref_small.to_prometheus()
    g, r = got.scalars(), ref.scalars()
    assert g.keys() == r.keys()
    for k in r:
        assert g[k] == r[k] or (math.isnan(g[k]) and math.isnan(r[k])), k


def test_metrics_prom_passes_the_schema(tmp_path):
    reg, _ = _drive_registry(registry)
    reg.write_prometheus(str(tmp_path / "metrics.prom"))
    assert _check_file(tmp_path / "metrics.prom") == []


# --------------------------------------------------------------- anomaly


def test_anomaly_detector_flags_what_jax_flags():
    """Losses with a NaN and a spike, step times with a regression: the
    same anomalies (kind, step, value) in the same order."""
    seq = [(2.0 - 0.01 * i, 0.10 + 0.001 * (i % 3)) for i in range(30)]
    seq[12] = (float("nan"), 0.1)
    seq[20] = (9.0, 0.1)
    seq[25] = (1.76, 0.9)
    found = []
    for mod in (anomaly, jax_anomaly):
        det = mod.AnomalyDetector()
        for i, (loss, t) in enumerate(seq):
            det.observe(i + 1, loss=loss, step_time=t)
        found.append([(a.kind, a.step, a.value) for a in det.anomalies])
    got, ref = found
    assert [a[:2] for a in got] == [a[:2] for a in ref]
    assert {a[0] for a in ref} == {"non_finite_loss", "loss_spike",
                                   "step_time_regression"}
    for g, r in zip(got, ref):
        assert g[2] == r[2] or (math.isnan(g[2]) and math.isnan(r[2]))
    assert anomaly.zscore([1.0, 1.0, 1.0], 1.0) == \
        jax_anomaly.zscore([1.0, 1.0, 1.0], 1.0)


# --------------------------------------------------------------- tracing


def _span_tree(mod, rec):
    for step in (1, 2, 3):
        rec.begin_step(step)
        with mod.span("data_wait"):
            pass
        with mod.span("train_step"):
            with mod.span("compile_train_step"):
                pass
        if step == 2:
            with mod.span("host_block"):
                pass
        rec.end_step()
    return rec.drain_window()


def test_tracer_window_totals_equal_jax(scripted_time, tmp_path):
    """The same span tree under one scripted clock: equal drain_window
    totals and equal trace.jsonl rows."""
    totals = []
    for mod, name in ((tracing, "port"), (jax_tracing, "jax")):
        rec = mod.TraceRecorder(str(tmp_path / name / "trace.jsonl"))
        rec.install()
        try:
            totals.append(_span_tree(mod, rec))
        finally:
            rec.uninstall()
            rec.close()
    assert totals[0] == totals[1]
    assert set(totals[0]) == {"data_wait", "train_step", "host_block"}
    assert (tmp_path / "port" / "trace.jsonl").read_text() == \
        (tmp_path / "jax" / "trace.jsonl").read_text()
    assert tracing.active_recorder() is None


def test_span_is_exception_transparent():
    def gen():
        yield 1

    it = gen()
    next(it)
    with pytest.raises(StopIteration):
        with tracing.span("data_wait"):
            next(it)


# ------------------------------------------------- goodput and flight


def _scripted_run(mods, logdir):
    """Scripted events through one package's ledger and recorder: spans
    of a fit with a compile, a checkpoint and an eval, flight events of a
    fit, a preemption, a close."""
    tr, gp, fr = mods
    led = gp.GoodputLedger(str(logdir / "goodput.json")).install()
    rec = fr.FlightRecorder(64, str(logdir / "flight.jsonl"))
    prev = fr.install_recorder(rec)
    try:
        with tr.span("checkpoint_restore"):
            pass
        led.mark_fit_begin(0)
        rec.record("fit_begin", step=0, total_steps=4)
        for step in range(1, 5):
            with tr.span("data_wait"):
                pass
            with tr.span("train_step"):
                if step == 1:
                    with tr.span("compile_train_step"):
                        pass
            rec.record("step", step=step, k=1)
        with tr.span("eval"):
            pass
        gp.note_checkpoint(4)
        with tr.span("checkpoint_save"):
            pass
        led.heartbeat(step=4)
        rec.record("preemption", source="trigger")
        rec.record("fit_end", step=4, preempted=True)
        rec.dump()
        led.close(ended="preempted")
        return led.report(), rec.events()
    finally:
        fr.install_recorder(prev)
        gp.install_ledger(None)


def test_goodput_and_flight_documents_equal_jax(scripted_time, tmp_path):
    """The same scripted events under one scripted clock: the same
    goodput.json and flight.jsonl documents, which the schema tool
    accepts."""
    docs = {}
    for name, mods in (("port", (tracing, goodput, flight_recorder)),
                       ("jax", (jax_tracing, jax_goodput, jax_flight))):
        (tmp_path / name).mkdir()
        docs[name] = _scripted_run(mods, tmp_path / name)
    (got_report, got_events), (ref_report, ref_events) = \
        docs["port"], docs["jax"]
    assert got_report == ref_report
    assert got_events == ref_events
    buckets = ref_report["merged"]["buckets"]
    assert {"compile", "train_step", "data_wait", "eval",
            "checkpoint_save", "checkpoint_restore"} <= set(buckets)
    for name in ("port", "jax"):
        for f in ("goodput.json", "flight.jsonl"):
            assert _check_file(tmp_path / name / f) == [], (name, f)
    assert json.loads((tmp_path / "port" / "goodput.json").read_text()) \
        == json.loads((tmp_path / "jax" / "goodput.json").read_text())
    assert goodput.default_ledger() is None
    assert flight_recorder.default_recorder() is None


def test_port_singletons_are_not_jax_singletons(tmp_path):
    rec = obs.FlightRecorder(8)
    prev = obs.install_recorder(rec)
    try:
        obs.record_event("step", step=1)
        assert jax_flight.default_recorder() is not rec
        assert [e["kind"] for e in rec.events()] == ["step"]
    finally:
        obs.install_recorder(prev)
    assert obs.default_registry() is not jax_registry.default_registry()


# --------------------------------------------------------------- capture


def _drive_capture(mod, tmp_path, time_fn):
    calls = []
    eng = mod.CaptureEngine(
        str(tmp_path), max_captures=2, cooldown_s=5.0, window_steps=2,
        time_fn=time_fn, profiler_start=lambda d: calls.append(("start", d)),
        profiler_stop=lambda: calls.append(("stop",)))
    out = [eng.request("static", steps=2, at_step=3, budget=False,
                       cooldown=False, dir=str(tmp_path / "static"))]
    for step in range(0, 12):
        eng.maybe_start(step)
        if step == 6:
            out.append(eng.request("step_time_regression", reason="slow"))
            out.append(eng.request("manual", cooldown=False))
        eng.maybe_stop(step + 1)
    out.append(eng.request("manual", cooldown=False))
    out.append(eng.request("bogus"))
    eng.abort(12)
    state = eng.state()
    return out, [c[0] for c in calls], state


def test_capture_engine_rows_equal_jax(scripted_time, tmp_path):
    """One request sequence (a static window, a triggered one, a refused
    second, budget and unknown-trigger refusals) under injected profiler
    calls and one scripted clock: the same answers, calls and manifest,
    which the schema tool accepts."""
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = _drive_capture(capture, tmp_path / "port", Clock())
    ref = _drive_capture(jax_capture, tmp_path / "jax", Clock())
    assert got[0] == ref[0] and got[1] == ref[1]
    strip = lambda rows: [{k: v for k, v in r.items() if k != "dir"}
                          for r in rows]
    assert strip(got[2]["captures"]) == strip(ref[2]["captures"])
    assert len(got[2]["captures"]) == 2
    assert _check_file(tmp_path / "port" / "captures.jsonl") == []


def test_capture_with_the_torch_profiler(tmp_path):
    """The default profiler calls: a window writes a Chrome trace of the
    profiled work, a manifest row, and flight events; a second session
    while one is open is refused."""
    from distributedtensorflow_tpu_torch.utils import profiler

    rec = obs.FlightRecorder(16)
    prev = obs.install_recorder(rec)
    try:
        eng = obs.CaptureEngine(str(tmp_path), window_steps=1)
        assert eng.request("manual", cooldown=False)[0]
        assert eng.maybe_start(0)
        with pytest.raises(RuntimeError, match="open already"):
            profiler.start_trace(str(tmp_path / "other"))
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
        row = eng.maybe_stop(1)
    finally:
        obs.install_recorder(prev)
    events = json.loads((tmp_path / "captures" / "0" / "trace.json")
                        .read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert row["dir"] == os.path.join("captures", "0")
    assert [e["kind"] for e in rec.events()] == ["capture_begin",
                                                "capture_end"]
    assert _check_file(tmp_path / "captures.jsonl") == []


# ------------------------------------------------- aggregate, memory, mfu


def test_host_aggregate_matches_jax_and_spans_ranks():
    values = {"t_step": 0.25, "t_data": 0.01}
    assert obs.host_aggregate(values) == jax_host_aggregate(values)

    def rank(r, group):
        return obs.host_aggregate({"t_step": [0.1, 0.4, 0.2][r],
                                   "t_data": 0.01 * r},
                                  build_mesh(MeshSpec(data=3), group))

    got = run_ranks(rank, 3)
    assert got[0] == got[1] == got[2]
    assert got[0]["t_step_host_min"] == 0.1
    assert got[0]["t_step_host_median"] == 0.2
    assert got[0]["t_step_host_max"] == 0.4
    assert got[0]["t_step_straggler"] == 1.0
    assert obs.spread_ratio(got[0], "t_step") == 2.0
    assert "straggler host 1" in obs.straggler_summary(got[0], "t_step")


def test_memory_record_has_the_jax_cpu_keys():
    """On the CPU: no device part (JAX's CPU devices report no memory
    stats either), host RSS and the census under JAX's names."""
    got = memory.record_fields()
    ref = jax_memory.record_fields()
    assert got.keys() == ref.keys()
    assert memory.device_memory_snapshot() == []
    model = torch.nn.Linear(4, 3)
    opt = torch.optim.Adam(model.parameters())
    model(torch.ones(2, 4)).sum().backward()
    opt.step()
    report = memory.state_bytes_report(model, opt)
    assert report == {"params": {0: 60}, "opt_state": {0: 128}}
    memory.set_train_state_bytes(report)
    try:
        assert memory.train_state_record_fields() == {
            "params_bytes_per_device": 60.0,
            "opt_state_bytes_per_device": 128.0}
        assert memory.memz()["train_state"] == report
    finally:
        memory.set_train_state_bytes(None)


def test_mfu_knows_the_h100_and_nothing_it_does_not_know():
    assert mfu.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert mfu.mfu_record_fields(989e12 / 2, 1.0,
                                 "NVIDIA H100 80GB HBM3") == {
        "mfu": 0.5, "mfu_analytic": 0.5}
    assert mfu.peak_flops("TPU v5 lite") is None
    assert mfu.mfu_record_fields(1e12, 1.0, "TPU v5 lite") == {}
    assert mfu.mfu_record_fields(1e12, 1.0, "") == {}
    assert mfu.mfu_record_fields(0.0, 1.0, "NVIDIA H100 80GB HBM3") == {}
    assert mfu.matmul_flops(2, 3, 4) == 48.0


# ------------------------------- checkpoint, preemption, watchdog hooks


def _state():
    model = torch.nn.Linear(4, 2)
    return tt.TrainState(0, model, torch.optim.SGD(model.parameters(),
                                                  lr=0.1))


@pytest.fixture
def recorder():
    rec = obs.FlightRecorder(64)
    prev = obs.install_recorder(rec)
    led = obs.GoodputLedger().install()
    yield rec, led
    obs.install_recorder(prev)
    goodput.install_ledger(None)


def _scalar(name):
    return obs.default_registry().scalars().get(name, 0.0)


def test_checkpoint_telemetry(tmp_path, recorder):
    """A save and a restore count, span, record flight events and anchor
    the goodput ledger; a corrupt step counts a verify failure and a
    checkpoint_corrupt event."""
    rec, led = recorder
    saves, restores, fails = (_scalar("checkpoint_saves_total"),
                              _scalar("checkpoint_restores_total"),
                              _scalar("checkpoint_verify_failures_total"))
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    state = _state()
    tracer = obs.TraceRecorder().install()
    try:
        state.step = 1
        assert mgr.save(1, state)
        state.step = 2
        assert mgr.save(2, state)
        mgr.wait()
        payload = tmp_path / "2" / "state.pt"
        raw = bytearray(payload.read_bytes())
        raw[-100] ^= 0xFF
        payload.write_bytes(bytes(raw))
        fresh = _state()
        assert mgr.restore_latest(fresh).step == 1
        list(skip_batches(iter(range(5)), 3))
        totals = tracer.drain_window()
    finally:
        tracer.uninstall()
    assert _scalar("checkpoint_saves_total") == saves + 2
    assert _scalar("checkpoint_restores_total") == restores + 1
    assert _scalar("checkpoint_verify_failures_total") == fails + 1
    assert _scalar("checkpoint_last_save_blocking_s") > 0
    assert {"checkpoint_save", "checkpoint_restore",
            "input_fastforward"} <= set(totals)
    kinds = [(e["kind"], e.get("step")) for e in rec.events()]
    assert kinds == [("checkpoint_begin", 1), ("checkpoint_end", 1),
                     ("checkpoint_begin", 2), ("checkpoint_end", 2),
                     ("checkpoint_corrupt", 2)]
    gen = led.report()["generations"][-1]
    assert [c[0] for c in gen["ckpts"]] == [1, 2]
    assert gen["resumed_step"] == 1
    assert {"checkpoint_save", "checkpoint_restore"} <= set(gen["buckets"])


def test_preemption_telemetry(tmp_path, recorder):
    """A notice counts once, records preemption and preemption_save,
    dumps the ring and closes the goodput generation as preempted."""
    rec, led = recorder
    rec.path = str(tmp_path / "flight.jsonl")
    before = _scalar("preemptions_total")
    handler = PreemptionHandler(CheckpointManager(str(tmp_path / "ck"),
                                                  async_save=False))
    try:
        handler.trigger()
        handler.trigger()
        assert handler.should_save(3)
        handler.save_and_exit(3, _state())
    finally:
        handler.uninstall()
    assert _scalar("preemptions_total") == before + 1
    kinds = [e["kind"] for e in rec.events()]
    assert kinds == ["preemption", "checkpoint_begin", "checkpoint_end",
                     "preemption_save", "goodput"]  # the ledger's close
    assert [json.loads(x)["kind"] for x in
            (tmp_path / "flight.jsonl").read_text().splitlines()] \
        == kinds[:-1]
    assert led.report()["generations"][-1]["ended"] == "preempted"


def test_watchdog_telemetry(tmp_path, recorder, capsys):
    """A stall fires once: the counter, the ping-age gauge and a
    watchdog_timeout flight event with the stacks, the ring dumped."""
    rec, _ = recorder
    rec.path = str(tmp_path / "flight.jsonl")
    before = _scalar("watchdog_timeouts_total")
    wd = Watchdog(0.2, poll_interval=0.05)
    try:
        deadline = time.monotonic() + 10
        while not wd.fired and time.monotonic() < deadline:
            time.sleep(0.02)
        assert wd.fired
        assert _scalar("watchdog_ping_age_seconds") >= 0.2
        wd.ping()
        assert _scalar("watchdog_ping_age_seconds") == 0.0
    finally:
        wd.stop()
    assert _scalar("watchdog_timeouts_total") == before + 1
    event = [e for e in rec.events() if e["kind"] == "watchdog_timeout"]
    assert len(event) == 1 and "dtf-watchdog" in event[0]["stacks"]
    assert (tmp_path / "flight.jsonl").exists()
    capsys.readouterr()
