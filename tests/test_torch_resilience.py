"""The port's resilience plane (``resilience/chaos.py``,
``resilience/supervisor.py``) against the JAX package's.

Both packages are imported in one process and fed the same inputs:
``classify_failure`` over a table of failures (each package's own chaos
faults and coordinator errors), ``SupervisorConfig.backoff_s``, the
``FaultPlan`` schema (the same plans accepted and rejected, with the same
messages), ``FAULT_KINDS`` (and ``tools/check_metrics_schema.py``'s), one
scripted fake trainer through both ``Supervisor`` s in the six scenarios
of ``tests/test_resilience.py`` (the same restart history: kind, attempt,
resumed step, backoff), and the goodput ledger's restart booking.  Then
the chaos units on the port's own pieces: the NaN injection and its
pairing (the module poison named by its flax top-level name, the k-step
copy of the metrics), a truncated save paired only after a restore fell
back past it (the port's asynchronous checkpoint files), the raising
faults, a ``resize`` without a controller left unrecovered, the net
faults armed in the port's ``net.rpc``, and ``faults.jsonl`` rows equal
to the JAX package's but for their time stamps.  The Trainer's
``clear_preempted`` and ``supervisor_status``.
"""

import json
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtensorflow_tpu import resilience as jres
from distributedtensorflow_tpu.obs.goodput import GoodputLedger as JaxLedger
from distributedtensorflow_tpu.parallel import coordinator as jcoord
from distributedtensorflow_tpu.resilience import supervisor as jsup
from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch import resilience as tres
from distributedtensorflow_tpu_torch.checkpoint import (
    CheckpointManager,
    PreemptionHandler,
)
from distributedtensorflow_tpu_torch.net import rpc as netrpc
from distributedtensorflow_tpu_torch.obs import goodput as tgoodput
from distributedtensorflow_tpu_torch.parallel import coordinator as tcoord
from distributedtensorflow_tpu_torch.resilience import supervisor as tsup
from distributedtensorflow_tpu_torch.train import (
    Trainer,
    TrainerConfig,
    TrainState,
    sgd,
)
from tools import check_metrics_schema

PACKAGES = {"jax": (jres, jcoord, jsup), "torch": (tres, tcoord, tsup)}


# --- classification ---------------------------------------------------------

#: name -> (exception factory of (resilience, coordinator) or None, kwargs)
CASES = {
    "preempted": (None, {"preempted": True}),
    "preempted_beats_exception": (
        lambda r, c: RuntimeError("x"), {"preempted": True}),
    "nan_anomaly": (None, {"nan_anomaly": True}),
    "nothing": (None, {}),
    "worker_kill": (
        lambda r, c: r.WorkerKilledFault("x", fault_id=0, step=1), {}),
    "data_stall_fault": (
        lambda r, c: r.DataStallFault("x", fault_id=0, step=1), {}),
    "injected_base": (
        lambda r, c: r.InjectedFault("x", fault_id=0, step=1), {}),
    "worker_unavailable": (lambda r, c: c.WorkerUnavailableError("x"), {}),
    "closure_aborted": (lambda r, c: c.ClosureAborted("x"), {}),
    "stop_iteration": (lambda r, c: StopIteration(), {}),
    "timeout": (lambda r, c: TimeoutError(), {}),
    "timeout_draining": (lambda r, c: TimeoutError(),
                         {"resize_draining": True}),
    "floating_point": (lambda r, c: FloatingPointError(), {}),
    "watchdog": (lambda r, c: RuntimeError("?"), {"watchdog_fired": True}),
    "watchdog_draining": (lambda r, c: RuntimeError("?"),
                          {"watchdog_fired": True, "resize_draining": True}),
    "unknown": (lambda r, c: RuntimeError("?"), {}),
    "stall_fault_beats_watchdog": (
        lambda r, c: r.DataStallFault("x", fault_id=0, step=1),
        {"watchdog_fired": True, "resize_draining": True}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_classify_failure_matches_jax(case):
    make, kw = CASES[case]
    kinds = {}
    for name, (res, coord, _) in PACKAGES.items():
        exc = make(res, coord) if make is not None else None
        kinds[name] = res.classify_failure(exc, **kw)
    assert kinds["torch"] == kinds["jax"], kinds
    assert kinds["torch"] in set(tres.FAULT_KINDS) | {
        "worker_crash", "data_exhausted", "resize_drain", "unknown",
        "injected"}


@pytest.mark.parametrize("cfg", [
    {}, {"backoff_base_s": 0.05},
    {"backoff_base_s": 1.0, "backoff_factor": 10.0, "backoff_max_s": 2.5},
    {"backoff_base_s": 0.0}, {"backoff_base_s": 3.0, "backoff_max_s": 7.0},
])
def test_backoff_matches_jax(cfg):
    got = [tres.SupervisorConfig(**cfg).backoff_s(a) for a in range(1, 9)]
    want = [jres.SupervisorConfig(**cfg).backoff_s(a) for a in range(1, 9)]
    assert got == want
    assert tres.SupervisorConfig().max_restarts == \
        jres.SupervisorConfig().max_restarts
    assert tsup.NONRETRYABLE_KINDS == jsup.NONRETRYABLE_KINDS


def test_fault_kinds_match_jax_and_the_schema_gate():
    assert tres.FAULT_KINDS == jres.FAULT_KINDS
    assert tres.NET_FAULT_KINDS == jres.NET_FAULT_KINDS
    assert tuple(check_metrics_schema.FAULT_KINDS) == tres.FAULT_KINDS


# --- fault plans ------------------------------------------------------------

PLANS = {
    "two_sorted": [{"step": 50, "kind": "nan_loss"},
                   {"step": 10, "kind": "worker_kill"}],
    "params_kept": [{"step": 3, "kind": "data_stall", "stall_s": 0.5},
                    {"step": 3, "kind": "net_drop", "calls": 2,
                     "endpoint": "data_worker"},
                    {"step": 1, "kind": "nan_loss", "module": "h1"}],
    "every_kind": [{"step": i, "kind": k}
                   for i, k in enumerate(jres.FAULT_KINDS)],
    "empty": [],
    "unknown_kind": [{"step": 1, "kind": "meteor_strike"}],
    "no_kind": [{"step": 1}],
    "negative_step": [{"step": -1, "kind": "nan_loss"}],
    "string_step": [{"step": "soon", "kind": "nan_loss"}],
    "bool_step": [{"step": True, "kind": "nan_loss"}],
    "float_step": [{"step": 2.0, "kind": "nan_loss"}],
    "not_an_object": [{"step": 1, "kind": "nan_loss"}, "nan_loss"],
}


def _parse(res, faults):
    try:
        plan = res.FaultPlan(faults)
    except ValueError as e:
        return ("error", str(e))
    return [(f.id, f.step, f.kind, f.params) for f in plan.faults]


@pytest.mark.parametrize("name", sorted(PLANS))
def test_fault_plan_schema_matches_jax(name):
    got = _parse(tres, PLANS[name])
    assert got == _parse(jres, PLANS[name])
    if name == "two_sorted":  # sorted by trigger step, re-id'd in order
        assert got == [(0, 10, "worker_kill", {}), (1, 50, "nan_loss", {})]


@pytest.mark.parametrize("doc", [
    {"faults": [{"step": 3, "kind": "nan_loss"}]},
    [{"step": 3, "kind": "preemption"}],
    {"nope": True},
    "a string",
    {"faults": [{"step": 3, "kind": "gremlins"}]},
])
def test_fault_plan_load_matches_jax(tmp_path, doc):
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(doc))
    out = {}
    for name, (res, _, _) in PACKAGES.items():
        try:
            out[name] = len(res.FaultPlan.load(str(path)))
        except ValueError as e:
            out[name] = str(e)
    assert out["torch"] == out["jax"]


# --- the supervisor's policy (one fake trainer, both packages) ---------------


class _FakeTrainer:
    """Duck-typed Trainer: scripted fit behaviours a call, the fit of
    either package (JAX's takes an ``rng``, the port's none)."""

    def __init__(self, behaviors, total_steps=100, checkpointer=None):
        self.config = types.SimpleNamespace(total_steps=total_steps)
        self.callbacks = []
        self.stop_training = False
        self.watchdog_fired = False
        self.supervisor_status = None
        self.checkpointer = checkpointer
        self.preemption = None
        self._preempted = False
        self._behaviors = behaviors
        self.fit_calls = 0

    @property
    def preempted(self):
        return self._preempted

    def clear_preempted(self):
        self._preempted = False

    def fit(self, state, it, *rng, eval_iter_fn=None):
        b = self._behaviors[min(self.fit_calls, len(self._behaviors) - 1)]
        self.fit_calls += 1
        return b(self, state)


class _FakeCheckpointer:
    def __init__(self, step=40):
        self.step = step
        self.last_restore_report = None
        self.calls = []

    def restore_latest(self, template, before_step=None):
        self.calls.append(before_step)
        self.last_restore_report = {"restored_step": self.step,
                                    "rejected": []}
        return types.SimpleNamespace(step=self.step)


def _done(total=100):
    return lambda t, s: types.SimpleNamespace(step=total)


def _raise(make):
    def b(t, s):
        raise make()
    return b


def _nan_fit(trainer, state):
    for cb in trainer.callbacks:
        cb.on_anomaly(trainer, types.SimpleNamespace(
            kind="non_finite_loss", step=50, message="nan", value=None))
    assert trainer.stop_training
    return types.SimpleNamespace(step=50)


def _preempted_fit(trainer, state):
    trainer._preempted = True
    return types.SimpleNamespace(step=60)


def _scenario(name, res, coord):
    """``(behaviours, checkpointer step or None, config kwargs)``."""
    if name == "retries_then_succeeds":
        return ([_raise(lambda: res.WorkerKilledFault("boom", fault_id=0,
                                                      step=10)),
                 _raise(lambda: RuntimeError("weird")), _done()], 8,
                {"max_restarts": 3, "backoff_base_s": 1.0,
                 "backoff_factor": 10.0, "backoff_max_s": 2.5})
    if name == "budget_exhaustion":
        return ([_raise(lambda: RuntimeError("always"))], None,
                {"max_restarts": 2, "backoff_base_s": 0.0})
    if name == "nan_restores_before_poison":
        return [_nan_fit, _done()], 30, {"max_restarts": 2,
                                         "backoff_base_s": 0.0}
    if name == "preemption_resume":
        return [_preempted_fit, _done()], 60, {"max_restarts": 2,
                                               "backoff_base_s": 0.0}
    if name == "data_exhausted":
        return [_raise(StopIteration)], None, {"max_restarts": 5}
    if name == "worker_crash":
        return ([_raise(lambda: coord.WorkerUnavailableError("gone")),
                 _raise(lambda: coord.ClosureAborted("cut")), _done()], 12,
                {"max_restarts": 4, "backoff_base_s": 0.25})
    assert name == "clean_finish"
    return [_done()], None, {}


SCENARIOS = ("retries_then_succeeds", "budget_exhaustion",
             "nan_restores_before_poison", "preemption_resume",
             "data_exhausted", "worker_crash", "clean_finish")


def _run_scenario(name, pkg, monkeypatch):
    res, coord, sup_mod = PACKAGES[pkg]
    sleeps = []
    monkeypatch.setattr(sup_mod.time, "sleep", sleeps.append)
    behaviors, ckpt_step, cfg = _scenario(name, res, coord)
    ckpt = _FakeCheckpointer(ckpt_step) if ckpt_step is not None else None
    trainer = _FakeTrainer(behaviors, checkpointer=ckpt)
    cold = types.SimpleNamespace(step=0)
    kw = {"state_template_fn": lambda: cold} if pkg == "jax" \
        else {"reinit_fn": lambda st: cold}
    sup = res.Supervisor(trainer, make_train_iter=lambda s: iter(()),
                         config=res.SupervisorConfig(**cfg), **kw)
    args = (types.SimpleNamespace(step=0),) + ((None,) if pkg == "jax"
                                               else ())
    out = {"fit_calls": None}
    try:
        state = sup.run(*args)
        out["step"] = int(state.step)
    except res.RestartBudgetExhausted as e:
        out["raised"] = ("budget", len(e.failures),
                         type(e.last_exception).__name__)
    except StopIteration:
        out["raised"] = ("StopIteration",)
    out["fit_calls"] = trainer.fit_calls
    out["restarts"] = [(r["kind"], r["attempt"], r["resumed_step"],
                        r["backoff_s"]) for r in sup.restarts]
    out["sleeps"] = sleeps
    out["restore_calls"] = ckpt.calls if ckpt is not None else None
    out["status"] = trainer.supervisor_status
    out["preempted"] = trainer.preempted
    return out


@pytest.mark.parametrize("name", SCENARIOS)
def test_supervisor_scenarios_match_jax(name, monkeypatch):
    got = _run_scenario(name, "torch", monkeypatch)
    want = _run_scenario(name, "jax", monkeypatch)
    assert got == want
    if name == "retries_then_succeeds":
        assert got["restarts"] == [("worker_kill", 1, 8, 1.0),
                                   ("unknown", 2, 8, 2.5)]
        assert got["step"] == 100 and got["status"]["restarts"] == 2
    if name == "nan_restores_before_poison":
        assert got["restore_calls"] == [50]
    if name == "budget_exhaustion":
        assert got["raised"] == ("budget", 3, "RuntimeError")
    if name == "data_exhausted":
        assert got["fit_calls"] == 1 and got["restarts"] == []
    if name == "preemption_resume":
        assert got["restarts"][0][0] == "preemption" and not got["preempted"]
    if name == "worker_crash":
        assert [r[0] for r in got["restarts"]] == ["worker_crash"] * 2


def test_supervisor_cold_restart_reinitialises_the_live_state(monkeypatch):
    """No usable checkpoint: the restart resumes from ``reinit_fn`` of the
    live state (in place), not from a new template."""
    monkeypatch.setattr(tsup.time, "sleep", lambda s: None)

    class _Empty(_FakeCheckpointer):
        def restore_latest(self, template, before_step=None):
            self.calls.append(before_step)
            self.last_restore_report = {"restored_step": None,
                                        "rejected": [{"step": 9}]}
            return None

    live = types.SimpleNamespace(step=0, reset=0)

    def reinit(st):
        assert st is live
        st.step, st.reset = 0, st.reset + 1
        return st

    def crash(trainer, state):
        state.step = 7
        raise RuntimeError("x")

    trainer = _FakeTrainer([crash, _done()], checkpointer=_Empty())
    sup = tres.Supervisor(trainer, make_train_iter=lambda s: iter(()),
                          reinit_fn=reinit,
                          config=tres.SupervisorConfig(max_restarts=1))
    assert sup.run(live).step == 100
    assert live.reset == 1 and sup.restarts[0]["resumed_step"] == 0


# --- goodput: the restart's badput ------------------------------------------


def test_goodput_note_restart_matches_jax(tmp_path):
    ledgers = {name: led(str(tmp_path / name / "goodput.json")) for name, led
               in (("jax", JaxLedger), ("torch", tgoodput.GoodputLedger))}
    # the booked seconds must fit in the wall time that elapsed
    time.sleep(0.4)
    span = types.SimpleNamespace(name="train_step", dur_s=0.03, children=[])
    for seconds in (0.05, 0.0, -1.0, 0.1):
        for led in ledgers.values():
            led.observe_span(span)
            led.note_restart(seconds)
    merged = {k: led.heartbeat(step=10) for k, led in ledgers.items()}
    for k in ("badput_restart", "train_step"):
        assert merged["torch"]["buckets"][k] == merged["jax"]["buckets"][k]
    assert merged["torch"]["buckets"]["badput_restart"] == \
        pytest.approx(0.15, abs=1e-6)
    for m in merged.values():
        assert sum(m["buckets"].values()) == pytest.approx(
            m["wall_s"], rel=0.01, abs=0.05)
    errors, _ = check_metrics_schema.check_file(
        str(tmp_path / "torch" / "goodput.json"))
    assert errors == []


def test_goodput_module_hook_without_a_ledger_is_a_no_op():
    prev = tgoodput.install_ledger(None)
    try:
        tgoodput.note_restart(1.0)
    finally:
        tgoodput.install_ledger(prev)


# --- chaos units ------------------------------------------------------------


def _rows(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _no_t(rows):
    return [{k: v for k, v in r.items() if k != "t"} for r in rows]


def test_nan_injection_and_pairing_match_jax(tmp_path):
    plan = [{"step": 3, "kind": "nan_loss"}]
    losses, rows = {}, {}
    for name, (res, _, _) in PACKAGES.items():
        d = tmp_path / name
        injector = res.ChaosInjector(res.FaultPlan(plan), logdir=str(d))
        if name == "jax":
            wrapped = injector.wrap_train_step(
                lambda state, batch, rng: (
                    types.SimpleNamespace(step=int(state.step) + 1),
                    {"loss": jnp.float32(1.0)}))
            call = lambda s: wrapped(s, None, None)  # noqa: E731
        else:
            wrapped = injector.wrap_train_step(
                lambda state, batch: (
                    types.SimpleNamespace(step=int(state.step) + 1),
                    {"loss": torch.tensor(1.0)}))
            call = lambda s: wrapped(s, None)  # noqa: E731
        state, out = types.SimpleNamespace(step=0), []
        for _ in range(4):
            state, metrics = call(state)
            out.append(float(metrics["loss"]))
        losses[name] = out
        assert injector.unrecovered() == [{"id": 0, "step": 3,
                                           "kind": "nan_loss"}]
        assert injector.mark_recovered(resumed_step=1, attempt=1) == 1
        assert injector.unrecovered() == []
        rows[name] = _rows(d / "faults.jsonl")
        errors, _ = check_metrics_schema.check_file(str(d / "faults.jsonl"))
        assert errors == []
    np.testing.assert_array_equal(losses["torch"], losses["jax"])
    assert np.isnan(losses["torch"][2]) and losses["torch"][3] == 1.0
    assert _no_t(rows["torch"]) == _no_t(rows["jax"])
    assert [r["phase"] for r in rows["torch"]] == ["injected", "recovered"]


def test_nan_poison_fills_the_flax_named_module_in_place(tmp_path):
    cfg = tm.gpt_tiny()
    model = tm.GPTLM(cfg, device="cpu")
    model.load_state_dict(tm.init_params(cfg, torch.Generator()
                                         .manual_seed(0)))
    state = TrainState.create(model, lambda named: sgd(named, 0.1))
    modules = tm.flax_modules(cfg)
    before = {n: p.data_ptr() for n, p in model.named_parameters()}
    injector = tres.ChaosInjector(
        tres.FaultPlan([{"step": 1, "kind": "nan_loss", "module": "h1"}]),
        logdir=str(tmp_path))
    # a k-step call: the loss is a column of the graph's table, copied
    table = torch.ones(2, 1)

    def step(st, batch):
        st.step += 2
        return st, {"loss": table[:, 0]}

    wrapped = injector.wrap_train_step(step, modules=modules)
    state, metrics = wrapped(state, None)
    assert torch.isnan(metrics["loss"]).all() and metrics["loss"].shape == (2,)
    assert torch.equal(table, torch.ones(2, 1))  # the table never sees it
    for n, p in model.named_parameters():
        assert p.data_ptr() == before[n]  # in place
        assert bool(torch.isnan(p).all()) == (modules[n] == "h1"), n
    assert any(m == "h1" for m in modules.values())
    row = _rows(tmp_path / "faults.jsonl")[0]
    assert row["module"] == "h1" and row["step"] == 1
    # a name that is no top-level module: a loss-only injection
    other = tres.ChaosInjector(
        tres.FaultPlan([{"step": 1, "kind": "nan_loss", "module": "nope"}]),
        logdir=str(tmp_path / "b"))
    state.step = 0
    _, metrics = other.wrap_train_step(step, modules=modules)(state, None)
    assert torch.isnan(metrics["loss"]).all()
    assert "module" not in _rows(tmp_path / "b" / "faults.jsonl")[0]


def _tiny_state(seed=0):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(16, 4))
    return TrainState.create(model, lambda named: sgd(named, 0.1))


def test_truncate_pairs_only_after_the_restore_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))  # asynchronous saves
    injector = tres.ChaosInjector(
        tres.FaultPlan([{"step": 2, "kind": "checkpoint_truncate"}]),
        logdir=str(tmp_path))
    proxy = injector.wrap_checkpointer(mgr)
    state = _tiny_state()
    state.step = 1
    assert proxy.save(1, state, force=True)
    assert injector.unrecovered() == []  # step 1 < trigger: nothing yet
    state.step = 2
    assert proxy.save(2, state, force=True)
    proxy.wait()
    assert [f["kind"] for f in injector.unrecovered()] == [
        "checkpoint_truncate"]
    size = (tmp_path / "ckpt" / "2" / "state.pt").stat().st_size
    assert size == (tmp_path / "ckpt" / "1" / "state.pt").stat().st_size // 2
    target = _tiny_state(seed=1)
    assert proxy.restore_latest(target) is target
    report = proxy.last_restore_report
    assert report["restored_step"] == 1 and target.step == 1
    rejected = [r["step"] for r in report["rejected"]]
    assert rejected == [2]
    # a restart that never rejected the truncated step must NOT pair it
    injector.mark_recovered(resumed_step=1, attempt=1, rejected_steps=[])
    assert injector.unrecovered() != []
    injector.mark_recovered(resumed_step=1, attempt=2,
                            rejected_steps=rejected)
    assert injector.unrecovered() == []
    rows = _rows(tmp_path / "faults.jsonl")
    assert rows[0]["truncated_step"] == 2
    assert [(r["phase"], r.get("attempt")) for r in rows] == [
        ("injected", None), ("recovered", 2)]
    mgr.close()


def test_data_stall_and_worker_kill_raise_as_in_jax(tmp_path):
    plan = [{"step": 2, "kind": "data_stall", "stall_s": 0.0},
            {"step": 5, "kind": "worker_kill"}]
    rows = {}
    for name, (res, _, _) in PACKAGES.items():
        injector = res.ChaosInjector(res.FaultPlan(plan),
                                     logdir=str(tmp_path / name))
        trainer = types.SimpleNamespace()
        injector.on_step_end(trainer, 1, None, {})  # before the triggers
        with pytest.raises(res.DataStallFault) as e:
            injector.on_step_end(trainer, 2, None, {})
        assert (e.value.kind, e.value.fault_id, e.value.step) == \
            ("data_stall", 0, 2)
        with pytest.raises(res.WorkerKilledFault):
            injector.on_step_end(trainer, 7, None, {})  # a late trigger
        injector.mark_recovered(resumed_step=0, attempt=1)
        rows[name] = _no_t(_rows(tmp_path / name / "faults.jsonl"))
    assert rows["torch"] == rows["jax"]
    assert [r["step"] for r in rows["torch"] if r["phase"] == "injected"] \
        == [2, 7]


def test_resize_without_a_controller_stays_unrecovered(tmp_path):
    rows = {}
    for name, (res, _, _) in PACKAGES.items():
        injector = res.ChaosInjector(
            res.FaultPlan([{"step": 3, "kind": "resize", "devices": 2}]),
            logdir=str(tmp_path / name))
        injector.on_step_end(None, 4, None, {})
        assert injector.mark_recovered(resumed_step=4, attempt=1) == 0
        assert injector.unrecovered() == [{"id": 0, "step": 3,
                                           "kind": "resize"}]
        rows[name] = _no_t(_rows(tmp_path / name / "faults.jsonl"))
    assert rows["torch"] == rows["jax"] == [
        {"id": 0, "step": 4, "kind": "resize", "phase": "injected",
         "devices": 2}]


def test_net_faults_arm_the_ports_net_layer(tmp_path):
    injector = tres.ChaosInjector(tres.FaultPlan([
        {"step": 1, "kind": "net_delay", "calls": 3, "delay_s": 0.01},
        {"step": 1, "kind": "net_drop", "calls": 2, "endpoint": "nowhere"},
        {"step": 2, "kind": "net_sever", "endpoint": "nowhere"},
    ]), logdir=str(tmp_path))
    netrpc.clear_faults()
    try:
        injector.on_step_end(None, 2, None, {})
        armed = {f.kind: f for f in netrpc._FAULTS}
        assert armed["net_delay"].calls == 3
        assert armed["net_delay"].delay_s == 0.01
        assert armed["net_drop"].calls == 2
        assert armed["net_drop"].match == "nowhere"
        # the restart path never claims a transport-recovered fault
        assert injector.mark_recovered(resumed_step=2, attempt=1) == 0
        # a successful call through a matching endpoint pairs the sever
        netrpc.note_success("nowhere:1")
        rows = _rows(tmp_path / "faults.jsonl")
        assert [(r["kind"], r["phase"]) for r in rows][-1] == (
            "net_sever", "recovered")
        assert rows[2]["severed"] == 0
    finally:
        netrpc.clear_faults()


# --- the Trainer's supervisor hooks -----------------------------------------


def test_trainer_clear_preempted_and_supervisor_status(tmp_path):
    model = torch.nn.Linear(4, 2)
    handler = PreemptionHandler(CheckpointManager(str(tmp_path)))
    trainer = Trainer(lambda s, b: (s, {}), TrainerConfig(total_steps=1),
                      preemption=handler)
    try:
        assert trainer.supervisor_status is None
        assert "supervisor" not in trainer.status()
        trainer.supervisor_status = {"restarts": 1, "max_restarts": 3}
        assert trainer.status()["supervisor"] == {"restarts": 1,
                                                  "max_restarts": 3}
        handler.trigger()
        trainer._preempted = True
        trainer.clear_preempted()
        assert not trainer.preempted and not handler.preempted
        assert not handler.should_save(1)
    finally:
        trainer.close()
        handler.uninstall()
    del model
