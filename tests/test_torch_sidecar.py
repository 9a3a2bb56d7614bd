"""The port's sidecar evaluator (``train/sidecar.py``) and
``train_torch.py --job evaluator`` against the JAX package's.

The reference's ``tests/test_sidecar.py`` behaviours on the port's
checkpoints: only the newest checkpoint is evaluated (catch-up) and a
later one is picked up while it polls, an empty directory ends at the
idle timeout, ``stop_after_step`` ends after the final step, and a
corrupt newest step is retried (never evaluated) until the idle timeout.
A ``--zero`` checkpoint saved by two gloo thread ranks restores into the
one-process (unchunked) template and evaluates as the ranks' own model.
Tiny gpt_lm and mnist_lenet (fp32, converted flax weights) give
``eval/*`` within 1e-5 relative of JAX's ``weighted_evaluate`` on the
same batches.  Last, ``train_torch.main`` with TF_CONFIG
``task.type == "evaluator"`` writes ``eval/accuracy`` at the trainer's
last step, as the reference's ``train.py`` does.
"""

import dataclasses
import json
import os
import threading
import time

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
from distributedtensorflow_tpu.models.gpt import lm_eval as jax_lm_eval
from distributedtensorflow_tpu.train import create_sharded_state
from distributedtensorflow_tpu.train import make_eval_step as jax_eval_step
from distributedtensorflow_tpu.train.trainer import (
    weighted_evaluate as jax_weighted_evaluate,
)
from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch import workloads as tw
from distributedtensorflow_tpu_torch.checkpoint import CheckpointManager
from distributedtensorflow_tpu_torch.data import device_put_batch
from distributedtensorflow_tpu_torch.parallel import zero
from distributedtensorflow_tpu_torch.parallel.mesh import MeshSpec
from distributedtensorflow_tpu_torch.testing import run_mesh
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401
from distributedtensorflow_tpu_torch.train import (
    SidecarEvaluator,
    TrainState,
    classification_eval,
    make_eval_step,
    make_train_step,
    sgd,
)

RTOL = 1e-5
LENET = tw.get_workload("mnist_lenet", test_size=True, global_batch_size=8)


def _lenet(seed=0):
    model = LENET.model_cls(LENET.cfg, device="cpu")
    model.load_state_dict(LENET.init_params(
        LENET.cfg, torch.Generator().manual_seed(seed)))
    state = TrainState.create(model, lambda p: sgd(p, 0.1))
    return state, make_eval_step(classification_eval(model))


def _batches(n=2, batch=8):
    rng = np.random.default_rng(0)
    return [device_put_batch({
        "image": rng.normal(size=(batch, 28, 28, 1)).astype(np.float32),
        "label": rng.integers(0, 10, (batch,)).astype(np.int32)}, "cpu")
        for _ in range(n)]


def _save(mgr, state, step):
    state.step = step
    mgr.save(step, state, force=True)
    mgr.wait()


def test_sidecar_skips_to_newest_and_picks_up_new(tmp_path):
    state, eval_step = _lenet()
    writer = CheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    _save(writer, state, 1)
    _save(writer, state, 2)
    template, eval_step = _lenet(seed=1)
    # a separate manager: the other process's view of the directory
    sidecar = SidecarEvaluator(
        CheckpointManager(str(tmp_path / "ckpt"), async_save=False),
        eval_step, lambda: iter(_batches()), template,
        poll_interval_s=0.05, max_evaluations=1)
    history = sidecar.run()
    assert set(history) == {2}  # catch-up: only the newest
    assert {"accuracy", "loss"} <= set(history[2])

    def save_later():
        time.sleep(0.3)
        _save(writer, state, 3)

    t = threading.Thread(target=save_later)
    t.start()
    sidecar.max_evaluations = 2
    history = sidecar.run()
    t.join()
    assert set(history) == {2, 3}
    assert template.step == 3


def test_sidecar_idle_timeout_on_empty_dir(tmp_path):
    state, eval_step = _lenet()
    sidecar = SidecarEvaluator(
        CheckpointManager(str(tmp_path / "empty"), async_save=False),
        eval_step, lambda: iter(_batches()), state,
        poll_interval_s=0.05, idle_timeout_s=0.3)
    t0 = time.monotonic()
    assert sidecar.run() == {}
    assert time.monotonic() - t0 < 10


def test_sidecar_stop_after_step(tmp_path):
    state, eval_step = _lenet()
    _save(CheckpointManager(str(tmp_path / "ckpt"), async_save=False),
          state, 5)
    sidecar = SidecarEvaluator(
        CheckpointManager(str(tmp_path / "ckpt"), async_save=False),
        eval_step, lambda: iter(_batches()), state,
        poll_interval_s=0.05, stop_after_step=5)
    assert set(sidecar.run()) == {5}


def test_sidecar_retries_a_corrupt_newest_step_until_idle(tmp_path):
    """A torn or corrupt checkpoint is "nothing evaluable yet": the
    sidecar never evaluates it, and its idle timeout bounds the wait."""
    state, eval_step = _lenet()
    ck = tmp_path / "ckpt"
    _save(CheckpointManager(str(ck), async_save=False), state, 2)
    payload = ck / "2" / "state.pt"
    raw = bytearray(payload.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    payload.write_bytes(bytes(raw))
    sidecar = SidecarEvaluator(
        CheckpointManager(str(ck), async_save=False),
        eval_step, lambda: iter(_batches()), state,
        poll_interval_s=0.05, idle_timeout_s=0.5)
    assert sidecar.run() == {}


def test_zero_checkpoint_of_two_ranks_restores_into_one_process(tmp_path):
    """A ``--zero`` trainer over data=2 (gloo thread ranks) saves its
    optimizer rows chunked at degree 2; the evaluator's unchunked
    template restores them (re-cut, not rejected as corrupt) and
    evaluates exactly the ranks' model."""
    from distributedtensorflow_tpu_torch.train import adamw

    ck = str(tmp_path / "ckpt")
    host = [{"image": b["image"].numpy(), "label": b["label"].numpy()}
            for b in _batches(2)]

    def train(rank, mesh):
        model = LENET.model_cls(LENET.cfg, device="cpu")
        model.load_state_dict(LENET.init_params(
            LENET.cfg, torch.Generator().manual_seed(0)))
        state = TrainState.create(model, lambda p: adamw(p, 1e-3), mesh,
                                  zero=zero.ZeroSharder(mesh))
        step = make_train_step(LENET.loss_fn(model, group=mesh), mesh=mesh)
        rows = {k: v[rank * 4:(rank + 1) * 4] for k, v in host[0].items()}
        state, _ = step(state, device_put_batch(rows, "cpu", mesh))
        mgr = CheckpointManager(ck, async_save=False, mesh=mesh)
        mgr.save(3, state, force=True)
        return {n: p.detach().clone() for n, p in model.named_parameters()}

    params, _ = run_mesh(train, MeshSpec(data=2), 2)
    model = LENET.model_cls(LENET.cfg, device="cpu")
    model.load_state_dict(LENET.init_params(
        LENET.cfg, torch.Generator().manual_seed(7)))
    template = TrainState.create(model, lambda p: adamw(p, 1e-3))
    eval_step = make_eval_step(classification_eval(model))
    sidecar = SidecarEvaluator(
        CheckpointManager(ck, async_save=False), eval_step,
        lambda: iter(_batches()), template, poll_interval_s=0.05,
        max_evaluations=1, idle_timeout_s=10)
    history = sidecar.run()
    assert set(history) == {3}
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), params[n]), n
    # the two batches have the same rows: the eval is their mean
    metric_fn = classification_eval(model)
    losses = [float(metric_fn(b)["loss"]) for b in _batches()]
    np.testing.assert_allclose(history[3]["loss"], np.mean(losses),
                               rtol=1e-6)


def _gpt_case():
    jcfg = dataclasses.replace(jax_gpt_tiny(), dtype=jnp.float32,
                               dropout_rate=0.0)
    tcfg = dataclasses.replace(tm.gpt_tiny(), dtype=torch.float32,
                               dropout_rate=0.0)
    variables = jax.device_get(jax.jit(JaxGPTLM(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 64), jnp.int32)))
    jw = jax_workloads.get_workload("gpt_lm", test_size=True,
                                    global_batch_size=8)
    model = tm.GPTLM(tcfg, device="cpu")
    model.load_state_dict(tm.params_from_flax(variables["params"], tcfg))
    template = tm.GPTLM(tcfg, device="cpu")
    return (jw, variables, jax_lm_eval(JaxGPTLM(jcfg)), model, template,
            tm.lm_eval)


def _lenet_case():
    jw = jax_workloads.get_workload("mnist_lenet", test_size=True,
                                    global_batch_size=8)
    variables = jax.device_get(jw.init_fn(jax.random.PRNGKey(3)))
    model = LENET.model_cls(LENET.cfg, device="cpu")
    model.load_state_dict(tm.params_from_flax(variables, LENET.cfg))
    template = LENET.model_cls(LENET.cfg, device="cpu")
    return jw, variables, jw.eval_fn, model, template, classification_eval


CASES = {"gpt_lm": _gpt_case, "mnist_lenet": _lenet_case}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sidecar_eval_matches_jax_weighted_evaluate(case, tmp_path,
                                                    dp_mesh):
    jw, variables, jeval, model, template, eval_fn = CASES[case]()
    host = [next(jw.input_fn(JaxInputContext(global_batch_size=8), s))
            for s in (999, 1000)]
    jstate, specs = create_sharded_state(
        lambda r: variables, jw.make_optimizer(), dp_mesh,
        jax.random.PRNGKey(0))
    ref = jax_weighted_evaluate(jax_eval_step(jeval, dp_mesh, specs),
                                jstate, iter(host))

    state = TrainState.create(model, lambda p: sgd(p, 0.1))
    _save(CheckpointManager(str(tmp_path), async_save=False), state, 4)
    target = TrainState.create(template, lambda p: sgd(p, 0.1))
    sidecar = SidecarEvaluator(
        CheckpointManager(str(tmp_path), async_save=False),
        make_eval_step(eval_fn(template)),
        lambda: (device_put_batch(b, "cpu") for b in host), target,
        poll_interval_s=0.05, max_evaluations=1,
        logdir=str(tmp_path / "logs"))
    history = sidecar.run()
    assert set(history) == {4} and set(history[4]) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(history[4][k], float(v), rtol=RTOL,
                                   err_msg=k)
    rows = [json.loads(line) for line in
            (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert rows[-1]["step"] == 4
    assert {f"eval/{k}" for k in ref} <= set(rows[-1])


def test_cli_evaluator_job(tmp_path, monkeypatch):
    """``train_torch.main`` with TF_CONFIG task.type "evaluator" (``--job
    auto``) runs the sidecar over the trainer's checkpoints and writes
    eval/accuracy at the last step, without a process group."""
    ckpt = str(tmp_path / "ckpt")
    logdir = str(tmp_path / "logs")
    base = ["--workload", "mnist_lenet", "--test-size", "--device", "cpu",
            "--steps", "4", "--checkpoint-dir", ckpt, "--batch-size", "16"]
    train_torch.main([*base, "--checkpoint-every", "2", "--log-every", "2"])
    monkeypatch.setenv("TF_CONFIG", json.dumps({
        "cluster": {"worker": ["localhost:12345"],
                    "evaluator": ["localhost:12399"]},
        "task": {"type": "evaluator", "index": 0}}))
    history = train_torch.main([*base, "--max-evaluations", "1",
                                "--poll-interval", "0.1",
                                "--idle-timeout", "60", "--logdir", logdir])
    assert set(history) == {4}
    assert not torch.distributed.is_initialized()
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert records and records[-1]["step"] == 4
    assert "eval/accuracy" in records[-1]
    np.testing.assert_allclose(records[-1]["eval/loss"],
                               history[4]["loss"], rtol=1e-6)


def test_evaluator_needs_a_checkpoint_dir():
    with pytest.raises(SystemExit, match="requires --checkpoint-dir"):
        train_torch.main(["--job", "evaluator", "--test-size", "--device",
                          "cpu"])
