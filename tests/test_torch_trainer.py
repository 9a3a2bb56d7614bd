"""The port's Trainer (``train/trainer.py``) against the JAX Trainer, its
behaviours, and ``train_torch.py`` on it.

- **Fits against JAX**: ``Trainer.fit`` of the port and of the JAX
  package (built as ``tests/test_trainer.py`` builds it: the step over
  the 8-device ``dp_mesh``) from one init (converted weights) on the same
  synthetic batches, fp32 at dropout 0, gpt_lm at test size and
  mnist_lenet: the logged losses and the weighted eval metrics agree
  within 1e-5 at every log step, and the records carry the same keys but
  for :data:`KEY_DIFFERENCES`.
- **Behaviours**: the rest of ``tests/test_trainer.py`` that has a
  meaning here (callbacks, keep-best, eval weighting, a finite eval
  iterator, preemption, the profile window, ``steps_per_call``), the
  accuracy gate, the status server during a fit, and eval over two thread
  ranks against one process (1e-6).
- **The CLI**: ``train_torch.main`` returns the losses of the per-step
  loop it replaced (``build`` and one ``step`` after another), bit for
  bit.
"""

import dataclasses
import json
import re
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train_torch
from distributedtensorflow_tpu import workloads as jax_workloads
from distributedtensorflow_tpu.data.input_pipeline import (
    InputContext as JaxInputContext,
)
from distributedtensorflow_tpu.models import GPTLM as JaxGPTLM
from distributedtensorflow_tpu.models import gpt_tiny as jax_gpt_tiny
from distributedtensorflow_tpu.models import lm_loss as jax_lm_loss
from distributedtensorflow_tpu.models.gpt import lm_eval as jax_lm_eval
from distributedtensorflow_tpu.train import create_sharded_state
from distributedtensorflow_tpu.train import make_eval_step as jax_eval_step
from distributedtensorflow_tpu.train import make_train_step as jax_train_step
from distributedtensorflow_tpu.train.trainer import Trainer as JaxTrainer
from distributedtensorflow_tpu.train.trainer import (
    TrainerConfig as JaxTrainerConfig,
)
from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch import train as tt
from distributedtensorflow_tpu_torch import workloads as tw
from distributedtensorflow_tpu_torch.checkpoint import (
    CheckpointManager,
    PreemptionHandler,
)
from distributedtensorflow_tpu_torch.data import InputContext, device_put_batch
from distributedtensorflow_tpu_torch.parallel.mesh import MeshSpec, build_mesh
from distributedtensorflow_tpu_torch.testing import run_ranks
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401

RTOL = 1e-5
#: Record keys only one package writes: the JAX step runs over 8 virtual
#: CPU devices, so its labelled per-device state gauges carry devices 1-7
#: too; the port's state lives on one device.
KEY_DIFFERENCES = re.compile(
    r"^(params|optimizer_state)_bytes_per_device\.device_[1-7]$")


def _torch_batches(source):
    for b in source:
        yield device_put_batch(b, "cpu")


# ---------------------------------------------------------------- vs JAX


def _gpt_case():
    jcfg = dataclasses.replace(jax_gpt_tiny(), dtype=jnp.float32,
                               dropout_rate=0.0)
    tcfg = dataclasses.replace(tm.gpt_tiny(), dtype=torch.float32,
                               dropout_rate=0.0)
    variables = jax.device_get(jax.jit(JaxGPTLM(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 64), jnp.int32)))
    jmodel = JaxGPTLM(jcfg)
    model = tm.GPTLM(tcfg, device="cpu")
    model.load_state_dict(tm.params_from_flax(variables["params"], tcfg))
    return ("gpt_lm", variables, jax_lm_loss(jmodel), jax_lm_eval(jmodel),
            model, tm.lm_loss(model), tm.lm_eval(model))


def _lenet_case():
    jw = jax_workloads.get_workload("mnist_lenet", test_size=True)
    variables = jax.device_get(jw.init_fn(jax.random.PRNGKey(3)))
    pw = tw.get_workload("mnist_lenet", test_size=True)
    model = pw.model_cls(pw.cfg, device="cpu")
    model.load_state_dict(tm.params_from_flax(variables, pw.cfg))
    return ("mnist_lenet", variables, jw.loss_fn, jw.eval_fn, model,
            pw.loss_fn(model), pw.eval_fn(model))


FIT_CASES = {"gpt_lm": _gpt_case, "mnist_lenet": _lenet_case}


def _rows(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.fixture
def fresh_telemetry(monkeypatch):
    """Fresh default registries for both packages, and no live JAX input
    controllers: other tests of this worker process leave theirs behind,
    and the records carry whatever they hold."""
    from distributedtensorflow_tpu.data import adaptive as jax_adaptive
    from distributedtensorflow_tpu.obs import registry as jax_registry
    from distributedtensorflow_tpu_torch.obs import registry

    monkeypatch.setattr(jax_adaptive, "_CONTROLLERS", {})
    prev = (jax_registry.set_default_registry(jax_registry.Registry()),
            registry.set_default_registry(registry.Registry()))
    yield
    jax_registry.set_default_registry(prev[0])
    registry.set_default_registry(prev[1])


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_matches_jax_trainer(case, dp_mesh, tmp_path, fresh_telemetry):
    """Four steps, a log and an eval (2 batches) every 2: the losses and
    eval metrics of both Trainers' metrics.jsonl within 1e-5, the same
    rows, and the same keys in each train row but for KEY_DIFFERENCES."""
    name, variables, jloss, jeval, model, loss_fn, eval_fn = \
        FIT_CASES[case]()
    jw = jax_workloads.get_workload(name, test_size=True, global_batch_size=8)
    pw = tw.get_workload(name, test_size=True, global_batch_size=8)
    jstate, specs = create_sharded_state(
        lambda r: variables, jw.make_optimizer(), dp_mesh,
        jax.random.PRNGKey(0))
    jtrain = jax_train_step(jloss, dp_mesh, specs)
    jevaluate = jax_eval_step(jeval, dp_mesh, specs)
    jsrc = lambda seed: jw.input_fn(JaxInputContext(global_batch_size=8),
                                    seed)
    jcfg = JaxTrainerConfig(total_steps=4, log_every=2, eval_every=2,
                            eval_steps=2, global_batch_size=8,
                            logdir=str(tmp_path / "jax"))
    with JaxTrainer(jtrain, jcfg, eval_step=jevaluate) as trainer:
        trainer.fit(jstate, jsrc(0), jax.random.PRNGKey(1),
                    eval_iter_fn=lambda: jsrc(999))

    state = tt.TrainState(0, model,
                          pw.make_optimizer(list(model.named_parameters())))
    psrc = lambda seed: _torch_batches(pw.input_fn(
        InputContext(global_batch_size=8), seed))
    cfg = tt.TrainerConfig(total_steps=4, log_every=2, eval_every=2,
                           eval_steps=2, global_batch_size=8,
                           logdir=str(tmp_path / "port"))
    with tt.Trainer(tt.make_train_step(loss_fn), cfg,
                    eval_step=tt.make_eval_step(eval_fn)) as trainer:
        out = trainer.fit(state, psrc(0), eval_iter_fn=lambda: psrc(999))
    assert out.step == 4

    ref, got = _rows(tmp_path / "jax" / "metrics.jsonl"), \
        _rows(tmp_path / "port" / "metrics.jsonl")
    assert [r["step"] for r in got] == [r["step"] for r in ref] == [2, 2, 4, 4]
    for g, r in zip(got, ref):
        metric_keys = [k for k in r if k.startswith("eval_")] or \
            ["loss"] + [k for k in ("perplexity", "accuracy") if k in r]
        for k in metric_keys:
            np.testing.assert_allclose(g[k], r[k], rtol=RTOL, err_msg=k)
        want = {k for k in r if not KEY_DIFFERENCES.match(k)}
        assert set(g) == want, (set(g) ^ want)


# ------------------------------------------------------------ behaviours


@pytest.fixture
def lenet():
    pw = tw.get_workload("mnist_lenet", test_size=True, global_batch_size=16)
    model = pw.model_cls(pw.cfg, device="cpu")
    model.load_state_dict(pw.init_params(pw.cfg,
                                         torch.Generator().manual_seed(0)))
    state = tt.TrainState(0, model,
                          pw.make_optimizer(list(model.named_parameters())))
    return (state, tt.make_train_step(pw.loss_fn(model)),
            tt.make_eval_step(pw.eval_fn(model)))


def _batches(n, batch_size=16, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield device_put_batch({
            "image": rng.standard_normal((batch_size, 28, 28, 1)).astype(
                np.float32),
            "label": rng.integers(0, 10, (batch_size,)).astype(np.int32),
        }, "cpu")


def test_fit_runs_and_evals(lenet, tmp_path):
    state, step, eval_step = lenet
    cfg = tt.TrainerConfig(total_steps=4, log_every=2, eval_every=2,
                           eval_steps=2, global_batch_size=16,
                           logdir=str(tmp_path / "logs"))
    with tt.Trainer(step, cfg, eval_step=eval_step) as trainer:
        out = trainer.fit(state, _batches(4),
                          eval_iter_fn=lambda: _batches(2, seed=99))
    assert out.step == 4
    assert "accuracy" in trainer._last_eval_metrics
    rows = _rows(tmp_path / "logs" / "metrics.jsonl")
    assert [r["step"] for r in rows] == [2, 2, 4, 4]
    assert (tmp_path / "logs" / "trace.jsonl").exists()
    assert (tmp_path / "logs" / "metrics.prom").exists()


def test_last_step_is_a_log_boundary(lenet):
    """A run of 5 steps logging every 2 logs steps 2, 4 and 5."""
    state, step, _ = lenet

    class Steps(tt.Callback):
        def __init__(self):
            self.logged = []

        def on_log(self, trainer, step, record):
            self.logged.append(step)
            assert isinstance(record["loss"], float)

    cb = Steps()
    cfg = tt.TrainerConfig(total_steps=5, log_every=2, global_batch_size=16)
    with tt.Trainer(step, cfg, callbacks=[cb]) as trainer:
        trainer.fit(state, _batches(5))
    assert cb.logged == [2, 4, 5]


def test_keep_best_checkpointer_under_trainer(lenet, tmp_path):
    """A best_metric manager works through Trainer.fit: the eval metrics
    ride every save, the saves before the first eval the worst score."""
    state, step, eval_step = lenet
    mgr = CheckpointManager(str(tmp_path / "best"), max_to_keep=2,
                            async_save=False, best_metric="accuracy",
                            best_mode="max")
    cfg = tt.TrainerConfig(total_steps=4, log_every=0, eval_every=2,
                           eval_steps=1, checkpoint_every=1,
                           global_batch_size=16)
    with tt.Trainer(step, cfg, eval_step=eval_step,
                    checkpointer=mgr) as trainer:
        out = trainer.fit(state, _batches(4),
                          eval_iter_fn=lambda: _batches(1, seed=99))
    assert mgr.all_steps(), "no checkpoints written"
    assert mgr.best_step() is not None
    assert out.step == 4
    mgr.close()


def test_eval_weighted_by_batch_size(lenet):
    """A ragged final batch counts per example, not per batch."""
    state, _, eval_step = lenet
    big, small = next(_batches(1, 24)), next(_batches(1, 8, seed=1))
    cfg = tt.TrainerConfig(total_steps=1, eval_steps=0, global_batch_size=16)
    got = tt.Trainer(lambda s, b: (s, {}), cfg,
                     eval_step=eval_step).evaluate(state, iter([big, small]))
    both = {k: torch.cat([big[k], small[k]]) for k in big}
    want = {k: float(v) for k, v in eval_step(state, both).items()}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)


def test_eval_steps_zero_consumes_finite_iterator(lenet):
    state, _, eval_step = lenet
    seen = []

    def gen():
        for b in _batches(3):
            seen.append(1)
            yield b

    cfg = tt.TrainerConfig(total_steps=1, eval_steps=0, global_batch_size=16)
    tt.Trainer(lambda s, b: (s, {}), cfg,
               eval_step=eval_step).evaluate(state, gen())
    assert len(seen) == 3  # the whole iterator, not the default 10


def test_preemption_stops_fit_with_consistent_save(lenet, tmp_path):
    """A preemption noticed during step 3 saves step 3 and stops there
    (not at total_steps, and without a second final save); a restart
    restores step 3 and runs to the end."""
    state, step, _ = lenet
    mgr = CheckpointManager(str(tmp_path / "pk"), async_save=False)
    handler = PreemptionHandler(mgr)

    def step_then_trigger(state, batch):
        out = step(state, batch)
        if out[0].step == 3:
            handler.trigger()  # a stand-in for SIGTERM
        return out

    cfg = tt.TrainerConfig(total_steps=10, log_every=0, global_batch_size=16)
    try:
        trainer = tt.Trainer(step_then_trigger, cfg, checkpointer=mgr,
                             preemption=handler)
        out = trainer.fit(state, _batches(10))
    finally:
        handler.uninstall()
    assert out.step == 3 and trainer.preempted
    assert mgr.all_steps() == [3]
    fresh = tt.TrainState(0, state.model, state.optimizer)
    assert mgr.restore_latest(fresh).step == 3
    out2 = tt.Trainer(step, cfg, checkpointer=mgr).fit(fresh, _batches(7))
    assert out2.step == 10


def test_profile_window_writes_its_trace(lenet, tmp_path):
    """--profile-dir: the window opens at profile_start, closes after
    profile_steps, and a Chrome trace naming the profiled steps' operators
    lands in the directory."""
    state, step, _ = lenet
    prof = tmp_path / "prof"
    cfg = tt.TrainerConfig(total_steps=6, log_every=0, global_batch_size=16,
                           profile_dir=str(prof), profile_start=3,
                           profile_steps=2)
    with tt.Trainer(step, cfg) as trainer:
        trainer.fit(state, _batches(6))
    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)
    rows = trainer.capture.rows
    assert [(r["trigger"], r["step_begin"], r["step_end"]) for r in rows] \
        == [("static", 3, 5)]


def test_callbacks_fire_and_can_stop(lenet):
    """Every hook fires with the right step, and stop_training ends the
    fit after the current step."""
    state, step, eval_step = lenet

    class Recorder(tt.Callback):
        def __init__(self):
            self.events = []

        def on_fit_begin(self, trainer, state):
            self.events.append(("fit_begin",))

        def on_step_end(self, trainer, step, state, metrics):
            self.events.append(("step", step))
            assert "loss" in metrics

        def on_eval_end(self, trainer, step, state, eval_metrics):
            self.events.append(("eval", step))

        def on_fit_end(self, trainer, state):
            self.events.append(("fit_end",))

    class StopAt(tt.Callback):
        def on_step_end(self, trainer, step, state, metrics):
            if step >= 3:
                trainer.stop_training = True

    rec = Recorder()
    cfg = tt.TrainerConfig(total_steps=10, log_every=0, eval_every=2,
                           eval_steps=1, global_batch_size=16)
    out = tt.Trainer(step, cfg, eval_step=eval_step,
                     callbacks=[rec, StopAt()]).fit(
        state, _batches(10), eval_iter_fn=lambda: _batches(1, seed=99))
    assert out.step == 3
    assert [e[1] for e in rec.events if e[0] == "step"] == [1, 2, 3]
    assert [e[1] for e in rec.events if e[0] == "eval"] == [2]
    assert rec.events[0] == ("fit_begin",) and rec.events[-1] == ("fit_end",)


def test_accuracy_gate_stops_the_fit(lenet):
    """target_metric: the fit ends at the first eval that reaches the
    value; a gate that can never fire is refused at setup."""
    state, step, eval_step = lenet
    cfg = tt.TrainerConfig(total_steps=10, log_every=0, eval_every=2,
                           eval_steps=1, global_batch_size=16,
                           target_metric="loss", target_value=1e9,
                           target_mode="min")
    out = tt.Trainer(step, cfg, eval_step=eval_step).fit(
        state, _batches(10), eval_iter_fn=lambda: _batches(1, seed=99))
    assert out.step == 2
    with pytest.raises(ValueError, match="never fire"):
        tt.TrainerConfig(total_steps=1, target_metric="accuracy",
                         target_value=0.9)
    with pytest.raises(ValueError, match="target_value is None"):
        tt.TrainerConfig(total_steps=1, eval_every=1,
                         target_metric="accuracy")


def test_steps_per_call_is_not_ported():
    """Multi-step calls are ported now (``tests/test_torch_multistep.py``):
    the config takes ``steps_per_call`` > 1 and ``input_prebundled`` and
    refuses a count below 1."""
    for kw in ({"steps_per_call": 3}, {"input_prebundled": True},
               {"steps_per_call": 3, "input_prebundled": True}):
        cfg = tt.TrainerConfig(total_steps=6, **kw)
        assert cfg.steps_per_call == kw.get("steps_per_call", 1)
    with pytest.raises(ValueError, match="steps_per_call"):
        tt.TrainerConfig(total_steps=6, steps_per_call=0)


def test_status_server_answers_during_a_fit(lenet, tmp_path):
    """On port 0, a Callback GETs every endpoint at step 2 of a CPU fit
    with the flight recorder on: each answers 200 (/healthz with
    ok, /flightz the ring so far, /varz the registry)."""
    from distributedtensorflow_tpu_torch import obs

    state, step, _ = lenet
    answers = {}

    class Probe(tt.Callback):
        def on_step_end(self, trainer, step, state, metrics):
            if step != 2:
                return
            port = trainer.status_server.port
            for path in ("/healthz", "/statusz", "/varz", "/threadz",
                         "/memz", "/flightz", "/goodputz", "/profilez"):
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}{path}", timeout=10) as r:
                    answers[path] = (r.status, r.read().decode())

    cfg = tt.TrainerConfig(total_steps=3, log_every=1, global_batch_size=16,
                           status_port=0, flight_recorder=True,
                           logdir=str(tmp_path))
    with tt.Trainer(step, cfg, callbacks=[Probe()]) as trainer:
        trainer.fit(state, _batches(3))
        assert obs.default_recorder() is trainer.flight
    assert obs.default_recorder() is None  # close() uninstalled it
    assert {p: s for p, (s, _) in answers.items()} == dict.fromkeys(
        answers, 200) and len(answers) == 8
    assert json.loads(answers["/healthz"][1])["ok"] is True
    assert "step" in answers["/statusz"][1]
    assert "engine_dispatches_total" in answers["/varz"][1]
    kinds = [e["kind"] for e in json.loads(answers["/flightz"][1])]
    assert kinds[:2] == ["fit_begin", "compile_begin"] and "log" in kinds
    assert json.loads(answers["/memz"][1])["devices"] == []  # the CPU
    flight = _rows(tmp_path / "flight.jsonl")
    assert flight[-1]["kind"] == "fit_end"


# ------------------------------------------------------- eval over ranks


EVAL_RANK_CASES = ("gpt_lm", "mnist_lenet", "bert_mlm")


@pytest.mark.parametrize("name", EVAL_RANK_CASES)
def test_eval_over_two_ranks_matches_one_process(name):
    """Two thread ranks, each with the same weights and its half of every
    global eval batch (rank-major), evaluate two batches through
    make_eval_step(..., mesh) and weighted_evaluate: every metric within
    1e-6 of one process on the global batches (BERT's masked positions
    differ between the halves, so its loss needs the global count)."""
    pw = tw.get_workload(name, test_size=True, global_batch_size=8)
    cfg = pw.cfg
    if hasattr(cfg, "dropout_rate"):
        cfg = dataclasses.replace(cfg, dtype=torch.float32, dropout_rate=0.0)
    weights = pw.init_params(cfg, torch.Generator().manual_seed(2))
    src = pw.input_fn(InputContext(global_batch_size=8), 5)
    batches = [device_put_batch(next(src), "cpu") for _ in range(2)]

    def evaluate(mesh=None, rank=0):
        model = pw.model_cls(cfg, device="cpu")
        model.load_state_dict(weights)
        state = tt.TrainState(0, model, torch.optim.SGD(
            model.parameters(), lr=0.0))
        group = {"group": mesh} if mesh is not None else {}
        step = tt.make_eval_step(pw.eval_fn(model, **group), mesh)
        shares = batches if mesh is None else [
            {k: v.chunk(2)[rank] for k, v in b.items()} for b in batches]
        return tt.weighted_evaluate(step, state, iter(shares))

    ref = evaluate()
    got = run_ranks(lambda r, g: evaluate(
        build_mesh(MeshSpec(data=2), g), r), 2)
    for rank in got:
        assert rank.keys() == ref.keys()
        for k in ref:
            np.testing.assert_allclose(rank[k], ref[k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)


# ------------------------------------------------------------------ CLI


CLI_CASES = {
    "gpt_lm": ["--workload", "gpt_lm", "--steps", "4", "--log-every", "1"],
    "mnist_lenet_log2": ["--workload", "mnist_lenet", "--steps", "5",
                         "--log-every", "2", "--batch-size", "16"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_losses_equal_the_per_step_loop(case, capsys):
    """train_torch.main on Trainer.fit returns, at each log step, the loss
    the per-step loop it replaced read (build, then one step after
    another, each loss fetched), bit for bit; the last step is logged."""
    argv = ["--test-size", "--device", "cpu", *CLI_CASES[case]]
    records = train_torch.main(argv)
    args = train_torch.parse_args(argv)
    _, state, step, batches = train_torch.build(args)
    losses = {}
    while state.step < args.steps:
        state, metrics = step(state, next(batches))
        losses[state.step] = float(metrics["loss"])
    want = sorted({s for s in losses if s % args.log_every == 0}
                  | {args.steps})
    assert [r["step"] for r in records] == want
    assert [r["loss"] for r in records] == [losses[s] for s in want]
    assert len(capsys.readouterr().out.strip().splitlines()) == len(want)


def test_cli_telemetry_flags(tmp_path, capsys):
    """The accuracy gate, the flight recorder, goodput and the trace from
    the command line: the logdir passes the schema tool, the gate's
    setup checks refuse what train.py refuses."""
    from tools import check_metrics_schema

    logdir = tmp_path / "run"
    records = train_torch.main([
        "--workload", "mnist_lenet", "--test-size", "--device", "cpu",
        "--batch-size", "16", "--steps", "40", "--log-every", "2",
        "--eval-every", "2", "--target-metric", "loss", "--target-value",
        "1e9", "--target-mode", "min", "--logdir", str(logdir),
        "--flight-recorder", "--goodput", "--estimate-flops", "on"])
    assert [r["step"] for r in records] == [2]  # the gate fired at step 2
    for name in ("metrics.jsonl", "flight.jsonl", "goodput.json",
                 "metrics.prom", "trace.jsonl"):
        assert (logdir / name).exists(), name
        if name != "trace.jsonl":
            errors, _ = check_metrics_schema.check_file(str(logdir / name))
            assert errors == [], (name, errors)
    doc = json.loads((logdir / "goodput.json").read_text())
    assert doc["generations"][-1]["ended"] == "clean"
    assert doc["merged"]["buckets"]["compile"] > 0
    capsys.readouterr()
    for argv, match in ((["--target-metric", "accuracy"],
                         "requires --target-value"),
                        (["--target-metric", "accuracy", "--target-value",
                          "0.9"], "requires --eval-every")):
        with pytest.raises(SystemExit, match=match):
            train_torch.main(["--test-size", "--device", "cpu", *argv])
