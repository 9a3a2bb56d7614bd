"""``train_torch.py --fault-plan`` and the restart flags end to end,
in-process on the CPU: the twins of the JAX package's
``tests/test_train_chaos_smoke.py``, ``test_train_netchaos_smoke.py`` and
``test_train_dynamics_smoke.py`` (which run ``train.py`` in a subprocess),
at their presets, flags and step counts.

- The five-fault plan on mnist_lenet (120 steps): every fault injected
  once and paired, at least two restarts, the truncated step rejected
  (``checkpoint_corrupt``) on the way to a verified restore, the NaN
  restart resuming below the torn step, ``badput_restart`` > 0 with the
  goodput buckets summing to wall within 1%, ``tools/check_metrics_schema``
  and ``tools/run_report`` green on the logdir, and the final parameters
  and optimizer state bit-equal to an uncut run from the same seed.
- A spent budget exits 3; a fault left unrecovered (a ``resize`` with no
  controller) exits 4, each closing the goodput ledger ``failed``.
- The net plan over ``--data-service 2``: gapless steps, no worker
  evicted, RPC retries, a full breaker cycle, the journal replayed across
  the dispatcher's kill, no restart.
- The NaN-provenance drill (``--dynamics-every``): the provenance names
  the poisoned module and the restart's flight event carries it.
- ``--mesh data=2`` over thread ranks: every rank resumes the same steps
  and the mesh's first rank alone writes ``faults.jsonl``.
- A supervised restart across ZeRO layouts: an unchunked checkpoint
  restored under ``--zero`` at degree 2, each rank's optimizer rows held
  against the JAX package's in-memory ``ZeroSharder.chunk_tree``.
- ``--profiler-port``: the server logs its port and ``POST
  /profilez?steps=2`` yields a capture in ``captures.jsonl``.
"""

import json
import logging
import os
import re
import shutil
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

import train_torch
from distributedtensorflow_tpu.parallel import zero as jax_zero
from distributedtensorflow_tpu_torch import resilience as tres
from distributedtensorflow_tpu_torch.parallel.bootstrap import free_port
from distributedtensorflow_tpu_torch.parallel.mesh import MeshSpec
from distributedtensorflow_tpu_torch.testing import intra_op_threads, run_mesh
from distributedtensorflow_tpu_torch.train import Callback
from tools import check_metrics_schema, run_report

MNIST = ["--workload", "mnist_lenet", "--test-size", "--batch-size", "32",
         "--device", "cpu"]

#: tests/test_train_chaos_smoke.py's plan
PLAN = [
    {"step": 35, "kind": "worker_kill"},
    {"step": 45, "kind": "checkpoint_truncate"},
    {"step": 70, "kind": "nan_loss"},
    {"step": 100, "kind": "data_stall", "stall_s": 0.1},
    {"step": 110, "kind": "preemption"},
]

#: tests/test_train_netchaos_smoke.py's plan
NET_PLAN = [
    {"step": 10, "kind": "net_delay", "calls": 3, "delay_s": 0.05},
    {"step": 20, "kind": "net_drop", "calls": 2, "endpoint": "data_worker"},
    {"step": 30, "kind": "net_sever", "endpoint": "data_worker"},
    {"step": 45, "kind": "dispatcher_kill"},
]


@pytest.fixture(autouse=True)
def _two_threads():
    with intra_op_threads(2):
        yield


def _plan(tmp_path, faults, name="plan.json"):
    path = tmp_path / name
    path.write_text(json.dumps({"faults": faults}))
    return str(path)


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _saved(ck, step):
    return _flat(torch.load(os.path.join(ck, str(step), "state.pt"),
                            weights_only=True))


def test_five_fault_plan_heals_to_the_uncut_run(tmp_path, caplog):
    logdir, ck = str(tmp_path / "logs"), str(tmp_path / "ck")
    caplog.set_level(logging.INFO)
    records = train_torch.main([
        *MNIST, "--steps", "120", "--log-every", "10",
        "--checkpoint-every", "20", "--checkpoint-dir", ck,
        "--logdir", logdir, "--fault-plan", _plan(tmp_path, PLAN),
        "--restart-backoff", "0.05", "--goodput", "--flight-recorder",
        "--watchdog-timeout", "60"])
    assert "done at step 120" in caplog.text
    assert records[-1]["step"] == 120

    # every injection paired with a recovery
    faults = _jsonl(os.path.join(logdir, "faults.jsonl"))
    injected = [r for r in faults if r["phase"] == "injected"]
    assert [r["kind"] for r in injected] == [f["kind"] for f in PLAN]
    assert {r["id"] for r in injected} == {
        r["id"] for r in faults if r["phase"] == "recovered"}

    # restarts, and the torn step rejected before a verified restore
    flight = _jsonl(os.path.join(logdir, "flight.jsonl"))
    restarts = [e for e in flight if e["kind"] == "restart"]
    assert [e["failure"] for e in restarts] == [
        "worker_kill", "nan_loss", "data_stall", "preemption"]
    assert [e["step"] for e in restarts] == [20, 40, 80, 110]
    corrupt = [e for e in flight if e["kind"] == "checkpoint_corrupt"]
    assert [e["step"] for e in corrupt] == [60]
    nan = [e for e in restarts if e["failure"] == "nan_loss"]
    assert nan[0]["step"] < corrupt[0]["step"]
    assert nan[0]["rejected_checkpoints"] == 1

    # goodput: the restarts booked, the buckets still a partition of wall
    doc = json.load(open(os.path.join(logdir, "goodput.json")))
    buckets, wall = doc["merged"]["buckets"], doc["merged"]["wall_s"]
    assert buckets.get("badput_restart", 0.0) > 0.0
    assert abs(sum(buckets.values()) - wall) <= max(0.01 * wall, 0.05)

    # the tools read the port's logdir unchanged
    for name in ("metrics.jsonl", "flight.jsonl", "faults.jsonl",
                 "goodput.json"):
        errors, _ = check_metrics_schema.check_file(
            os.path.join(logdir, name))
        assert errors == [], (name, errors)
    res = run_report.build_report(logdir)["resilience"]
    assert res["faults_injected"] == 5 and res["unpaired"] == []
    assert res["restarts"] == 4 and res["fallback_restores"] == 1
    assert "resilience: 5 fault(s) injected" in run_report.render(
        run_report.build_report(logdir))

    # bit-equal to the uncut run from the same seed
    uncut = str(tmp_path / "uncut")
    train_torch.main([*MNIST, "--steps", "120", "--log-every", "60",
                      "--checkpoint-dir", uncut])
    got, want = _saved(ck, 120), _saved(uncut, 120)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if torch.is_tensor(v):
            assert torch.equal(got[k], v), k
        else:
            assert got[k] == v, k


def test_cold_restart_reinitialises_the_live_state(tmp_path, caplog):
    """A kill before the first checkpoint: the restart finds nothing to
    restore and re-initialises the live state from ``--seed`` (weights,
    optimizer state, step 0), so the run ends as the uncut run does."""
    caplog.set_level(logging.INFO)
    ck, uncut = str(tmp_path / "ck"), str(tmp_path / "uncut")
    train_torch.main([*MNIST, "--steps", "12", "--log-every", "4",
                      "--checkpoint-every", "8", "--checkpoint-dir", ck,
                      "--fault-plan", _plan(tmp_path, [
                          {"step": 6, "kind": "worker_kill"}]),
                      "--restart-backoff", "0.01"])
    assert "no usable checkpoint; cold restart from step 0" in caplog.text
    train_torch.main([*MNIST, "--steps", "12", "--log-every", "12",
                      "--checkpoint-dir", uncut])
    got, want = _saved(ck, 12), _saved(uncut, 12)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if torch.is_tensor(v):
            assert torch.equal(got[k], v), k


def test_spent_budget_exits_3(tmp_path, caplog):
    with pytest.raises(SystemExit) as e:
        train_torch.main([
            *MNIST, "--steps", "40", "--log-every", "10",
            "--logdir", str(tmp_path / "logs"), "--goodput",
            "--fault-plan", _plan(tmp_path, [
                {"step": 5, "kind": "worker_kill"},
                {"step": 6, "kind": "data_stall"}]),
            "--max-restarts", "1", "--restart-backoff", "0.05"])
    assert e.value.code == 3
    assert "supervisor gave up" in caplog.text
    doc = json.load(open(tmp_path / "logs" / "goodput.json"))
    assert doc["generations"][-1]["ended"] == "failed"


def test_unrecovered_fault_exits_4(tmp_path, caplog):
    logdir = str(tmp_path / "logs")
    with pytest.raises(SystemExit) as e:
        train_torch.main([
            *MNIST, "--steps", "10", "--log-every", "5", "--logdir", logdir,
            "--goodput", "--fault-plan", _plan(tmp_path, [
                {"step": 4, "kind": "resize", "devices": 2}])])
    assert e.value.code == 4
    assert "no elastic controller attached" in caplog.text
    assert "UNRECOVERED" in caplog.text
    rows = _jsonl(os.path.join(logdir, "faults.jsonl"))
    assert [(r["kind"], r["phase"]) for r in rows] == [("resize",
                                                        "injected")]
    doc = json.load(open(os.path.join(logdir, "goodput.json")))
    assert doc["generations"][-1]["ended"] == "failed"


def test_network_chaos_over_the_data_service(tmp_path, caplog):
    logdir = str(tmp_path / "logs")
    caplog.set_level(logging.INFO)
    train_torch.main([
        *MNIST, "--steps", "70", "--log-every", "5", "--data-service", "2",
        "--logdir", logdir, "--fault-plan", _plan(tmp_path, NET_PLAN),
        "--restart-backoff", "0.05", "--flight-recorder"])
    assert "done at step 70" in caplog.text
    faults = _jsonl(os.path.join(logdir, "faults.jsonl"))
    injected = [r for r in faults if r["phase"] == "injected"]
    assert [r["kind"] for r in injected] == [f["kind"] for f in NET_PLAN]
    assert {r["id"] for r in injected} == {
        r["id"] for r in faults if r["phase"] == "recovered"}
    flight = _jsonl(os.path.join(logdir, "flight.jsonl"))
    assert not [e for e in flight if e["kind"] == "restart"]

    # exactly once: gapless steps, no worker evicted, a stream resumed
    rows = _jsonl(os.path.join(logdir, "metrics.jsonl"))
    steps = [r["step"] for r in rows if "loss" in r]
    assert steps == list(range(5, 75, 5))
    last = rows[-1]
    assert last.get("data_service_workers_dropped_total", 0) == 0
    assert last.get("data_service_resharded_splits_total", 0) == 0
    assert last.get("data_service_stream_resumes_total", 0) >= 1

    prom = open(os.path.join(logdir, "metrics.prom")).read()
    retries = sum(float(m.group(1)) for m in re.finditer(
        r'^rpc_retries_total\{[^}]*\} (\S+)', prom, re.M))
    assert retries > 0
    journal = os.path.join(logdir, "dispatcher.journal")
    target = _jsonl(journal)
    assert target[0]["kind"] == "open"
    assert "replay" in [r["kind"] for r in target]
    for state in ("open", "half_open", "closed"):
        m = re.search(r'^breaker_transitions_total\{endpoint="dispatcher:'
                      r'[^"]*",to="%s"\} (\S+)' % state, prom, re.M)
        assert m and float(m.group(1)) >= 1, state
    for name in ("metrics.jsonl", "faults.jsonl", "metrics.prom",
                 "dispatcher.journal"):
        errors, _ = check_metrics_schema.check_file(
            os.path.join(logdir, name))
        assert errors == [], (name, errors)
    rep = run_report.build_report(logdir)
    assert rep["resilience"]["unpaired"] == []
    assert rep["rpc"]["journal"]["replays"] >= 1


def test_nan_provenance_drill_names_the_poisoned_module(tmp_path):
    logdir = str(tmp_path / "logs")
    train_torch.main([
        "--workload", "gpt_lm", "--test-size", "--device", "cpu",
        "--steps", "60", "--batch-size", "8", "--log-every", "5",
        "--seed", "0", "--dynamics-every", "5", "--checkpoint-every", "10",
        "--checkpoint-dir", str(tmp_path / "ck"), "--logdir", logdir,
        "--fault-plan", _plan(tmp_path, [
            {"step": 30, "kind": "nan_loss", "module": "h1"}]),
        "--restart-backoff", "0.05", "--flight-recorder"])
    flight = _jsonl(os.path.join(logdir, "flight.jsonl"))
    prov = [e for e in flight if e["kind"] == "nan_provenance"]
    assert prov and prov[0]["module"] == "h1" and prov[0]["step"] == 30
    restarts = [e for e in flight if e["kind"] == "restart"]
    assert [e["failure"] for e in restarts] == ["nan_loss"]
    assert restarts[0]["nan_module"] == "h1"
    assert restarts[0]["step"] < 30
    faults = _jsonl(os.path.join(logdir, "faults.jsonl"))
    assert [(r["phase"], r.get("module")) for r in faults] == [
        ("injected", "h1"), ("recovered", None)]
    rows = _jsonl(os.path.join(logdir, "dynamics.jsonl"))
    assert rows and all(r["step"] % 5 == 0 for r in rows)
    for name in ("dynamics.jsonl", "flight.jsonl", "faults.jsonl"):
        errors, _ = check_metrics_schema.check_file(
            os.path.join(logdir, name))
        assert errors == [], (name, errors)


class _Supervisors(tres.Supervisor):
    """``resilience.Supervisor`` that keeps every instance (a rank's)."""

    made: list = []

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        _Supervisors.made.append((threading.get_ident(), self))


def _main_on_ranks(argv, spec, world, monkeypatch):
    """``train_torch.main(argv)`` on each thread rank, the rank's mesh in
    place of the process group ``bootstrap_mesh`` would start."""
    local = threading.local()

    def body(rank, mesh):
        local.mesh = mesh
        return train_torch.main(argv)

    monkeypatch.setattr(train_torch, "bootstrap_mesh",
                        lambda args: (local.mesh, torch.device("cpu")))
    return run_mesh(body, spec, world, timeout=120)


def test_mesh_ranks_resume_the_same_steps(tmp_path, monkeypatch):
    logdir = str(tmp_path / "logs")
    _Supervisors.made = []
    monkeypatch.setattr(tres, "Supervisor", _Supervisors)
    plan = [{"step": 7, "kind": "worker_kill"},
            {"step": 8, "kind": "checkpoint_truncate"},
            {"step": 12, "kind": "nan_loss"},
            # a rank group agrees on a preemption every 10th step
            {"step": 20, "kind": "preemption"}]
    ranks = _main_on_ranks([
        *MNIST, "--steps", "24", "--log-every", "2", "--mesh", "data=2",
        "--dist-backend", "gloo", "--checkpoint-every", "5",
        "--checkpoint-dir", str(tmp_path / "ck"), "--logdir", logdir,
        "--fault-plan", _plan(tmp_path, plan), "--restart-backoff", "0.01",
        "--prefetch-depth", "0"], MeshSpec(data=2), 2, monkeypatch)
    assert [r[-1]["step"] for r in ranks] == [24, 24]
    assert len(_Supervisors.made) == 2
    histories = [[(r["kind"], r["resumed_step"]) for r in sup.restarts]
                 for _, sup in _Supervisors.made]
    assert histories[0] == histories[1] == [
        ("worker_kill", 5), ("nan_loss", 5), ("preemption", 20)]
    faults = _jsonl(os.path.join(logdir, "faults.jsonl"))
    # one writer: each fault injected and recovered once, ids in order
    assert [(r["id"], r["phase"]) for r in faults
            if r["phase"] == "injected"] == [(i, "injected")
                                             for i in range(4)]
    assert sorted(r["id"] for r in faults if r["phase"] == "recovered") \
        == [0, 1, 2, 3]
    assert len(faults) == 8
    errors, _ = check_metrics_schema.check_file(
        os.path.join(logdir, "faults.jsonl"))
    assert errors == []
    saved = torch.load(tmp_path / "ck" / "24" / "state.pt",
                       weights_only=True)
    assert saved["step"] == 24


class _FitBegins(Callback):
    """Each rank's optimizer rows at every fit's start."""

    seen: dict = {}

    def on_fit_begin(self, trainer, state):
        rows = {"step": int(state.step),
                "momentum": [state.optimizer.state[c]["momentum_buffer"]
                             .clone() for c in state.zero.chunks],
                "chunks": [c.clone() for c in state.zero.chunks]}
        _FitBegins.seen.setdefault(threading.get_ident(), []).append(rows)


def test_restart_across_zero_layouts(tmp_path, monkeypatch):
    ck = str(tmp_path / "ck")
    base = [*MNIST, "--mesh", "data=2", "--dist-backend", "gloo",
            "--log-every", "4", "--prefetch-depth", "0"]
    # unchunked checkpoints at steps 4 and 8
    _main_on_ranks([*base, "--steps", "8", "--checkpoint-every", "4",
                    "--checkpoint-dir", ck], MeshSpec(data=2), 2,
                   monkeypatch)
    uncut = str(tmp_path / "uncut")
    shutil.copytree(ck, uncut)
    saved8 = torch.load(os.path.join(ck, "8", "state.pt"),
                        weights_only=True)
    # --zero resumes from step 8; a kill at 10 restores step 8 again
    _FitBegins.seen = {}
    make = train_torch.Trainer
    monkeypatch.setattr(
        train_torch, "Trainer", lambda *a, callbacks=(), **kw: make(
            *a, callbacks=[*callbacks, _FitBegins()], **kw))
    _main_on_ranks([*base, "--zero", "--steps", "12", "--checkpoint-dir",
                    ck, "--fault-plan", _plan(tmp_path, [
                        {"step": 10, "kind": "worker_kill"}]),
                    "--restart-backoff", "0.01"], MeshSpec(data=2), 2,
                   monkeypatch)
    monkeypatch.setattr(train_torch, "Trainer", make)
    _main_on_ranks([*base, "--zero", "--steps", "12", "--checkpoint-dir",
                    uncut], MeshSpec(data=2), 2, monkeypatch)
    got, want = _saved(ck, 12), _saved(uncut, 12)
    for k, v in want.items():
        if torch.is_tensor(v):
            assert torch.equal(got[k], v), k
    # each rank's rows after the supervised restore: JAX's chunk_tree of
    # the saved unchunked slots and parameters
    names = list(saved8["params"])
    params = {n: saved8["params"][n].numpy() for n in names}
    slots = {n: saved8["opt_state"]["state"][i]["momentum_buffer"].numpy()
             for i, n in enumerate(names)}
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("data",))
    sharder = jax_zero.ZeroSharder(jmesh)
    want_slots = jax.device_get(sharder.chunk_tree(slots))
    want_rows = jax.device_get(sharder.chunk_tree(params))
    fits = sorted(_FitBegins.seen.values(), key=lambda f: id(f))
    assert len(fits) == 2
    for rank_fits in fits:
        assert [f["step"] for f in rank_fits] == [8, 8]
    by_rank = {}
    for rank_fits in fits:
        row = rank_fits[1]
        rank = next(r for r in range(2) if all(
            np.array_equal(row["chunks"][j].numpy(), want_rows[n][r])
            for j, n in enumerate(names)))
        by_rank[rank] = row
    assert sorted(by_rank) == [0, 1]
    for rank, row in by_rank.items():
        for j, n in enumerate(names):
            np.testing.assert_array_equal(row["momentum"][j].numpy(),
                                          want_slots[n][rank], err_msg=n)


class _PostProfilez(Callback):
    """At step 3, ``POST /profilez?steps=2`` to the profiler server."""

    def __init__(self, port, answers):
        self.port, self.answers = port, answers

    def on_step_end(self, trainer, step, state, metrics):
        if step == 3:
            req = urllib.request.Request(
                f"http://127.0.0.1:{self.port}/profilez?steps=2", data=b"",
                method="POST")
            with urllib.request.urlopen(req, timeout=10) as r:
                self.answers.append((r.status, json.loads(r.read())))


def test_profiler_port_serves_on_demand_captures(tmp_path, monkeypatch,
                                                 caplog):
    caplog.set_level(logging.INFO)
    logdir = str(tmp_path / "logs")
    port, answers = free_port(), []
    make = train_torch.Trainer
    monkeypatch.setattr(
        train_torch, "Trainer", lambda *a, callbacks=(), **kw: make(
            *a, callbacks=[*callbacks, _PostProfilez(port, answers)], **kw))
    train_torch.main([*MNIST, "--steps", "10", "--log-every", "5",
                      "--logdir", logdir, "--profiler-port", str(port)])
    assert f"profiler server listening on port {port}" in caplog.text
    assert answers and answers[0][0] == 200 and answers[0][1]["accepted"]
    rows = _jsonl(os.path.join(logdir, "captures.jsonl"))
    assert [(r["trigger"], r["step_end"] - r["step_begin"],
             r.get("aborted")) for r in rows] == [("manual", 2, None)]
    assert os.path.exists(os.path.join(logdir, "captures", "0",
                                       "trace.json"))
    with pytest.raises(OSError):  # stopped with the run
        urllib.request.urlopen(f"http://127.0.0.1:{port}/profilez",
                               timeout=2)
