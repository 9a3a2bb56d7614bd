"""The port's closure dispatcher (``parallel/coordinator.py``) and
``TrainState.snapshot`` against the JAX package's, in one process.

Every thread-mode scenario of the reference's ``tests/test_coordinator.py``
runs the same closures through both packages' ``Coordinator``: the same
results, the same parked and re-raised errors (type and message), the
same deltas of the ``coordinator_closures_*_total`` counters and the same
flight events (``coordinator_retry``, ``coordinator_failure``).  That
covers fetch of one value and of a nested structure, 50 closures over 4
workers, an application error parked and re-raised at ``join``, the
closures queued behind a failure cancelled, a retryable error re-queued,
the retry cap, ``join`` as a barrier, a preempted worker's closures moved
to the others, per-worker datasets and a shutdown cancelling the queue.
Then the snapshot fan-out during training (the reference's
``test_eval_fanout_during_training``): gpt_tiny in fp32 from converted
flax weights trains on the main thread while eval closures run on
``snapshot()`` copies; every snapshot's eval loss equals JAX's at the
same step within 1e-5 relative, and the training losses too.  Process
workers spawn processes, which no test here does: ``chip_smoke.py``'s
``jobs`` phase runs them on the card.
"""

import dataclasses
import itertools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtensorflow_tpu import obs as jax_obs
from distributedtensorflow_tpu import workloads as jax_workloads
from distributedtensorflow_tpu.data.input_pipeline import (
    InputContext as JaxInputContext,
)
from distributedtensorflow_tpu.models import GPTLM as JaxGPTLM
from distributedtensorflow_tpu.models import gpt_tiny as jax_gpt_tiny
from distributedtensorflow_tpu.models import lm_loss as jax_lm_loss
from distributedtensorflow_tpu.models.gpt import lm_eval as jax_lm_eval
from distributedtensorflow_tpu.parallel import coordinator as jcoord
from distributedtensorflow_tpu.train import create_sharded_state
from distributedtensorflow_tpu.train import make_eval_step as jax_eval_step
from distributedtensorflow_tpu.train import make_train_step as jax_train_step
from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch import obs as port_obs
from distributedtensorflow_tpu_torch import train as tt
from distributedtensorflow_tpu_torch import workloads as tw
from distributedtensorflow_tpu_torch.data import InputContext, device_put_batch
from distributedtensorflow_tpu_torch.parallel import coordinator as pcoord
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401

PACKAGES = {"jax": (jcoord, jax_obs), "port": (pcoord, port_obs)}
COUNTERS = ("_M_SCHEDULED", "_M_FINISHED", "_M_RETRIED", "_M_FAILED")
RTOL = 1e-5


def _raises(fn) -> tuple[str, str] | None:
    """The type and message of what ``fn()`` raises, or None."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the outcome under test
        return type(e).__name__, str(e)
    return None


# ------------------------------------------------------------ scenarios
# Each takes the coordinator module and returns a comparable outcome.


def _fetch_one(c):
    with c.Coordinator(num_workers=2) as coord:
        rv = coord.schedule(lambda x, y: x + y, (2, 3))
        value = rv.fetch(timeout=10)
        coord.join()
        return value, coord.done()


def _many_parallel(c):
    with c.Coordinator(num_workers=4) as coord:
        rvs = [coord.schedule(lambda i=i: i * i) for i in range(50)]
        coord.join(timeout=30)
        return [rv.fetch() for rv in rvs]


def _nested_fetch(c):
    with c.Coordinator(num_workers=2) as coord:
        rvs = {"a": coord.schedule(lambda: 1), "b": [coord.schedule(lambda: 2)]}
        coord.join(timeout=10)
        return coord.fetch(rvs)


def _app_error_at_join(c):
    def boom():
        raise ValueError("application bug")

    with c.Coordinator(num_workers=2) as coord:
        rv = coord.schedule(boom)
        at_join = _raises(lambda: coord.join(timeout=10))
        at_fetch = _raises(lambda: rv.fetch(timeout=10))
        # parked once: the next join is clean
        again = _raises(lambda: coord.join(timeout=10))
        return at_join, at_fetch, again


def _cancel_after_failure(c):
    release = threading.Event()

    def boom():
        raise RuntimeError("fail fast")

    coord = c.Coordinator(num_workers=1)
    try:
        coord.schedule(lambda: release.wait(10))
        coord.schedule(boom)
        late = coord.schedule(lambda: 42)  # queued behind the failure
        release.set()
        at_join = _raises(lambda: coord.join(timeout=10))
        return at_join, _raises(lambda: late.fetch(timeout=10))
    finally:
        coord.shutdown()


def _retry_requeues(c):
    attempts = []

    def flaky():
        attempts.append(threading.get_ident())
        if len(attempts) == 1:
            raise c.WorkerUnavailableError("worker preempted")
        return "ok"

    with c.Coordinator(num_workers=2) as coord:
        value = coord.schedule(flaky).fetch(timeout=10)
        coord.join(timeout=10)
        return value, len(attempts)


def _retry_cap(c):
    def always_unavailable():
        raise c.WorkerUnavailableError("dead resource")

    with c.Coordinator(num_workers=2, max_retries=3) as coord:
        rv = coord.schedule(always_unavailable)
        return (_raises(lambda: rv.fetch(timeout=10)),
                _raises(lambda: coord.join(timeout=10)))


def _preempted_worker(c):
    with c.Coordinator(num_workers=2) as coord:
        coord.preempt_worker(0)
        rvs = [coord.schedule(lambda i=i: i) for i in range(10)]
        coord.join(timeout=30)
        return [rv.fetch() for rv in rvs]


def _per_worker_dataset(c):
    with c.Coordinator(num_workers=3) as coord:
        ds = coord.create_per_worker_dataset(
            lambda worker_id: (worker_id * 100 + j for j in itertools.count()))
        got = [coord.schedule(next, (ds,)).fetch(timeout=10)
               for _ in range(9)]
        by_worker: dict[int, list[int]] = {}
        for v in got:
            by_worker.setdefault(v // 100, []).append(v % 100)
        # each worker consumed its OWN iterator: a prefix of its stream
        return (isinstance(ds, c.PerWorker),
                all(vals == list(range(len(vals)))
                    for vals in by_worker.values()), len(got))


def _join_barrier(c):
    done = []

    def slow(i):
        time.sleep(0.02)
        done.append(i)

    with c.Coordinator(num_workers=4) as coord:
        for i in range(8):
            coord.schedule(slow, (i,))
        coord.join(timeout=30)
        return sorted(done)


def _shutdown_cancels(c):
    release = threading.Event()
    coord = c.Coordinator(num_workers=1)
    coord.schedule(lambda: release.wait(10))
    queued = coord.schedule(lambda: 1)  # stuck behind the blocker
    coord._queue.close()
    release.set()
    out = _raises(lambda: queued.fetch(timeout=10))
    coord.shutdown()
    return out, _raises(lambda: coord.schedule(lambda: 2))


def _remote_value(c):
    rv = c.RemoteValue()
    before = rv.done()
    rv._set_value(7)
    return before, rv.done(), rv.fetch(), \
        _raises(lambda: c.RemoteValue().fetch(timeout=0.01))


def _refusals(c):
    return (_raises(lambda: c.Coordinator(num_workers=0)),
            _raises(lambda: c.Coordinator(num_workers=1,
                                          worker_status_ports=True)))


def _thread_mode_has_no_pids(c):
    with c.Coordinator(num_workers=2) as coord:
        return (coord.worker_pids(), coord.worker_status_addrs(),
                coord.num_workers,
                _raises(lambda: coord.kill_worker_process(0)))


SCENARIOS = {f.__name__.lstrip("_"): f for f in (
    _fetch_one, _many_parallel, _nested_fetch, _app_error_at_join,
    _cancel_after_failure, _retry_requeues, _retry_cap, _preempted_worker,
    _per_worker_dataset, _join_barrier, _shutdown_cancels, _remote_value,
    _refusals, _thread_mode_has_no_pids)}


def _run(pkg, scenario):
    """The scenario's outcome, its counter deltas and the kinds of its
    flight events, through one package."""
    c, o = PACKAGES[pkg]
    ring = o.FlightRecorder(256)
    prev = o.install_recorder(ring)
    before = [getattr(c, m).value() for m in COUNTERS]
    try:
        out = SCENARIOS[scenario](c)
    finally:
        o.install_recorder(prev)
    deltas = [getattr(c, m).value() - b for m, b in zip(COUNTERS, before)]
    kinds = sorted(e["kind"] for e in ring.events()
                   if e["kind"].startswith("coordinator_"))
    return out, deltas, kinds


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_thread_mode_scenario_matches_jax(scenario):
    ref = _run("jax", scenario)
    got = _run("port", scenario)
    assert got == ref


def test_queue_depth_gauge_and_wasted_seconds_names():
    """The registry families carry the reference's names."""
    names = {pcoord._M_QUEUE_DEPTH.name, pcoord._M_WASTED_S.name,
             pcoord._M_RESPAWNS.name, *(getattr(pcoord, m).name
                                        for m in COUNTERS)}
    assert names == {jcoord._M_QUEUE_DEPTH.name, jcoord._M_WASTED_S.name,
                     jcoord._M_RESPAWNS.name, *(getattr(jcoord, m).name
                                                for m in COUNTERS)}
    with pcoord.Coordinator(num_workers=1) as coord:
        coord.schedule(lambda: 1).fetch(timeout=10)
        coord.join(timeout=10)
    assert pcoord._M_QUEUE_DEPTH.value() == 0


def test_process_executors_use_spawn(monkeypatch):
    """The process pool takes the ``spawn`` context (never fork: the
    parent may hold a CUDA context) and runs ``_subprocess_worker_main``
    in each worker; checked with a stand-in context, no process started."""
    made = {}

    class Conn:
        def send(self, msg):
            made.setdefault("sent", []).append(msg)

        def close(self):
            pass

    class Proc:
        pid = 4242

        def __init__(self, target, args, daemon, name):
            made.update(target=target, args=args, daemon=daemon, name=name)

        def start(self):
            made["started"] = True

        def is_alive(self):
            return False

        def join(self, timeout=None):
            pass

    class Context:
        def Pipe(self):
            return Conn(), Conn()

        Process = Proc

    monkeypatch.setattr(pcoord.mp, "get_context",
                        lambda method: made.setdefault("method", method)
                        and Context())
    ex = pcoord._SubprocessExecutor(3)
    assert made["method"] == "spawn" and made["started"]
    assert made["target"] is pcoord._subprocess_worker_main
    assert made["daemon"] and made["name"] == "coordinator-proc-3"
    assert ex.pid == 4242 and ex.backoff_remaining() == 0.0
    ex.close()
    assert made["sent"] == [None]  # the graceful stop


# ------------------------------------------------------ snapshot fan-out


N_SNAPSHOTS, N_FIXED, MAX_STEPS = 3, 4, 200


def _gpt():
    jcfg = dataclasses.replace(jax_gpt_tiny(), dtype=jnp.float32,
                               dropout_rate=0.0)
    tcfg = dataclasses.replace(tm.gpt_tiny(), dtype=torch.float32,
                               dropout_rate=0.0)
    variables = jax.device_get(jax.jit(JaxGPTLM(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 64), jnp.int32)))
    jw = jax_workloads.get_workload("gpt_lm", test_size=True,
                                    global_batch_size=8)
    batches = list(itertools.islice(
        jw.input_fn(JaxInputContext(global_batch_size=8), 0), 3))
    return jcfg, tcfg, variables, jw, batches


def _fanout(schedule_eval, train_step, n_batches):
    """The reference's loop: step on the main thread, fan a snapshot out
    after each of the first steps, keep stepping until every snapshot's
    eval has finished (so "all done" is seen between optimizer steps)."""
    losses, rvs, steps = [], [], 0
    while steps < N_FIXED or not all(rv.done() for rv in rvs):
        assert steps < MAX_STEPS, "eval closures did not finish while " \
                                  "the training loop was running"
        loss = train_step(steps % n_batches)
        if steps < N_FIXED:
            losses.append(loss)
        if len(rvs) < N_SNAPSHOTS:
            rvs.append(schedule_eval())
        steps += 1
    return losses, [rv.fetch() for rv in rvs]


def test_snapshot_fanout_during_training_matches_jax(dp_mesh):
    jcfg, tcfg, variables, jw, batches = _gpt()
    eval_batch = batches[0]

    jmodel = JaxGPTLM(jcfg)
    jstate, specs = create_sharded_state(
        lambda r: variables, jw.make_optimizer(), dp_mesh,
        jax.random.PRNGKey(0))
    jtrain = jax_train_step(jax_lm_loss(jmodel), dp_mesh, specs)
    jeval = jax_eval_step(jax_lm_eval(jmodel), dp_mesh, specs)
    box = {"state": jstate}

    def jstep(i):
        box["state"], m = jtrain(box["state"], batches[i],
                                 jax.random.PRNGKey(1))
        return float(m["loss"])

    with jcoord.Coordinator(num_workers=2) as coord:
        ref_losses, ref_evals = _fanout(
            lambda: coord.schedule(
                lambda s: float(jeval(s, eval_batch)["loss"]),
                (box["state"].snapshot(),)),
            jstep, len(batches))

    pw = tw.get_workload("gpt_lm", test_size=True, global_batch_size=8)
    model = tm.GPTLM(tcfg, device="cpu")
    model.load_state_dict(tm.params_from_flax(variables["params"], tcfg))
    state = tt.TrainState(0, model,
                          pw.make_optimizer(list(model.named_parameters())))
    train = tt.make_train_step(tm.lm_loss(model))
    tbatches = [device_put_batch(b, "cpu") for b in batches]
    teval = device_put_batch(eval_batch, "cpu")
    pbox = {"state": state}

    def pstep(i):
        pbox["state"], m = train(pbox["state"], tbatches[i])
        return float(m["loss"])

    def peval(snap):
        return float(tm.lm_eval(snap.model)(teval)["loss"])

    with pcoord.Coordinator(num_workers=2) as coord:
        losses, evals = _fanout(
            lambda: coord.schedule(peval, (pbox["state"].snapshot(),)),
            pstep, len(batches))

    np.testing.assert_allclose(losses, ref_losses, rtol=RTOL)
    np.testing.assert_allclose(evals, ref_evals, rtol=RTOL)
    # the snapshots were taken after steps 1, 2, 3: training moved them
    assert len(set(evals)) == N_SNAPSHOTS


def test_snapshot_is_a_deep_copy_of_the_state():
    """A snapshot keeps the step, parameters, buffers and optimizer
    moments it was taken at while the state trains on in place; it can
    itself take a step (its optimizer is over its own parameters)."""
    pw = tw.get_workload("cifar_resnet20", test_size=True,
                         global_batch_size=4)
    model = pw.model_cls(pw.cfg, device="cpu")
    model.load_state_dict(pw.init_params(pw.cfg,
                                         torch.Generator().manual_seed(0)))
    state = tt.TrainState.create(model, pw.make_optimizer)
    step = tt.make_train_step(pw.loss_fn(model))
    src = pw.input_fn(InputContext(global_batch_size=4), 0)
    state, _ = step(state, device_put_batch(next(src), "cpu"))
    snap = state.snapshot()
    frozen = {k: v.clone() for k, v in snap.model.state_dict().items()}
    moments = {k: v.clone() for k, v in
               snap.optimizer.state_dict()["state"][0].items()
               if torch.is_tensor(v)}
    assert snap.step == state.step == 1
    assert all(torch.equal(v, state.model.state_dict()[k])
               for k, v in frozen.items())
    state, _ = step(state, device_put_batch(next(src), "cpu"))
    assert state.step == 2 and snap.step == 1
    now = snap.model.state_dict()
    assert all(torch.equal(now[k], v) for k, v in frozen.items())
    assert any(not torch.equal(state.model.state_dict()[k], v)
               for k, v in frozen.items() if k.endswith("mean"))
    assert all(torch.equal(snap.optimizer.state_dict()["state"][0][k], v)
               for k, v in moments.items())
    owned = {id(p) for p in snap.model.parameters()}
    assert all(id(p) in owned for g in snap.optimizer.param_groups
               for p in g["params"])
    snap2, m = tt.make_train_step(pw.loss_fn(snap.model))(
        snap, device_put_batch(next(src), "cpu"))
    assert snap2.step == 2 and np.isfinite(float(m["loss"]))
