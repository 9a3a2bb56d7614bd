"""The port's checkpoint plane against the JAX package's and against itself.

Mirrors ``tests/test_checkpoint.py`` (round trip, empty directory,
rotation, keep-best, preemption, a conformance case for every ported
preset), then integrity (corrupt steps, commit markers, the manifest's
fields), exact resume (in process and through ``train_torch.main``,
SIGTERM included), a JAX checkpoint carried into the port, ranks as
threads, and the utilities (``derive_seed``, ``tree_fingerprint``,
``Watchdog``, ``skip_batches``, ``enable_determinism``, ``trace``).
Everything runs on the CPU at test size.  Bit-for-bit comparisons run on
one intra-op thread: torch's multi-threaded CPU reductions differ in
their last bits from run to run.
"""

import dataclasses
import json
import logging
import os
import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch

import train_torch
from distributedtensorflow_tpu.checkpoint import (
    CheckpointManager as JaxCheckpointManager,
)
from distributedtensorflow_tpu.checkpoint import integrity as jax_integrity
from distributedtensorflow_tpu.data.input_pipeline import (
    InputContext as JaxInputContext,
)
from distributedtensorflow_tpu.models import GPTLM as JaxGPTLM
from distributedtensorflow_tpu.models import lm_loss as jax_lm_loss
from distributedtensorflow_tpu.train import optimizers as jax_optimizers
from distributedtensorflow_tpu.train.engine import _step_body
from distributedtensorflow_tpu.train.state import TrainState as JaxTrainState
from distributedtensorflow_tpu.utils import determinism as jax_determinism
from distributedtensorflow_tpu import workloads as jax_workloads
from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch import train as tt
from distributedtensorflow_tpu_torch import workloads as tw
from distributedtensorflow_tpu_torch.checkpoint import (
    CheckpointCorruptError,
    CheckpointManager,
    PreemptionHandler,
)
from distributedtensorflow_tpu_torch.checkpoint import integrity
from distributedtensorflow_tpu_torch.checkpoint import manager as tmanager
from distributedtensorflow_tpu_torch.data import (
    InputContext,
    device_put_batch,
    skip_batches,
)
from distributedtensorflow_tpu_torch.parallel import collectives
from distributedtensorflow_tpu_torch.testing import run_ranks
from distributedtensorflow_tpu_torch.utils import (
    Watchdog,
    annotate,
    derive_seed,
    enable_determinism,
    trace,
    tree_fingerprint,
)


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lenet_state(seed=0):
    """LeNet-5 under sgd at 0.1 with momentum 0.9 (the JAX test's
    ``make_state``)."""
    cfg = tm.LeNetConfig()
    model = tm.LeNet5(cfg, device="cpu")
    model.load_state_dict(tm.init_params(cfg,
                                         torch.Generator().manual_seed(seed)))
    return tt.TrainState.create(
        model, lambda p: tt.sgd(p, 0.1, momentum=0.9))


def _lenet_step(state, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"image": torch.from_numpy(
        rng.standard_normal((16, 28, 28, 1)).astype(np.float32)),
        "label": torch.from_numpy(rng.integers(0, 10, 16))}
    step = tt.make_train_step(tt.classification_loss(state.model))
    return step(state, batch)


def _fingerprint(state):
    return tree_fingerprint({"model": state.model.state_dict(),
                             "optimizer": state.optimizer.state_dict(),
                             "step": state.step})


# ------------------------------------------- mirror of tests/test_checkpoint


def test_save_restore_roundtrip(tmp_path):
    state, _ = _lenet_step(_lenet_state())
    mgr = CheckpointManager(tmp_path / "ckpt", async_save=False)
    assert mgr.save(1, state, force=True)
    mgr.wait()
    fresh = _lenet_state(seed=1)
    restored = mgr.restore_latest(fresh)
    assert restored is fresh and restored.step == 1
    for (n, a), b in zip(state.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), n
    # the optimizer's slots (momentum) too
    for p, q in zip(state.model.parameters(), fresh.model.parameters()):
        assert torch.equal(state.optimizer.state[p]["momentum_buffer"],
                           fresh.optimizer.state[q]["momentum_buffer"])
    assert mgr.last_restore_report == {"restored_step": 1, "rejected": []}
    mgr.close()


def test_restore_latest_none_on_empty(tmp_path):
    mgr = CheckpointManager(tmp_path / "empty", async_save=False)
    assert mgr.restore_latest(_lenet_state()) is None
    assert mgr.latest_step() is None and mgr.all_steps() == []
    mgr.close()


def test_rotation(tmp_path):
    state = _lenet_state()
    mgr = CheckpointManager(tmp_path / "rot", max_to_keep=2)
    for s in (1, 2, 3):
        state.step = s
        assert mgr.save(s, state, force=True)
    mgr.wait()
    assert mgr.latest_step() == 3 and mgr.all_steps() == [2, 3]
    assert sorted(os.listdir(tmp_path / "rot" / "manifests")) == \
        ["2.json", "3.json"]
    assert not mgr.save(3, state, force=True)  # already saved
    mgr.close()


def test_save_interval(tmp_path):
    state = _lenet_state()
    mgr = CheckpointManager(tmp_path / "every", save_interval_steps=3,
                            async_save=False)
    saved = [s for s in range(1, 8) if mgr.save(s, state)]
    assert saved == [3, 6]
    assert mgr.save(7, state, force=True)
    assert mgr.all_steps() == [3, 6, 7]


def test_keep_best_retention(tmp_path):
    """best_metric retention keeps the best-K checkpoints, not the latest."""
    state = _lenet_state()
    mgr = CheckpointManager(tmp_path / "best", max_to_keep=2,
                            async_save=False, best_metric="accuracy",
                            best_mode="max")
    for step, acc in {10: 0.2, 20: 0.9, 30: 0.5, 40: 0.7}.items():
        mgr.save(step, state, metrics={"accuracy": acc})
    mgr.wait()
    assert set(mgr.all_steps()) == {20, 40}  # the two best, not the latest
    assert mgr.best_step() == 20
    with pytest.raises(ValueError, match="best_metric"):
        mgr.save(50, state)  # metrics required
    low = CheckpointManager(tmp_path / "low", max_to_keep=1,
                            async_save=False, best_metric="loss",
                            best_mode="min")
    for step, loss in {1: 3.0, 2: 1.0, 3: 2.0}.items():
        low.save(step, state, metrics={"loss": loss})
    assert low.all_steps() == [2] and low.best_step() == 2
    mgr.close()


def test_preemption_handler_trigger_and_save(tmp_path):
    state = _lenet_state()
    mgr = CheckpointManager(tmp_path / "pre", async_save=False)
    exits = []
    handler = PreemptionHandler(mgr, on_exit=lambda: exits.append(1))
    try:
        assert not handler.should_save(0) and not handler.preempted
        handler.trigger()
        assert handler.should_save(1) and handler.manager is mgr
        state.step = 7
        handler.save_and_exit(7, state)
        assert mgr.latest_step() == 7 and exits == [1]
        handler.reset()
        assert not handler.should_save(8)
    finally:
        handler.uninstall()
    mgr.close()


def _build(name, seed=0):
    args = train_torch.parse_args(
        ["--workload", name, "--test-size", "--device", "cpu",
         "--batch-size", "8", "--seed", str(seed)])
    return args, train_torch.build(args)


@pytest.mark.parametrize("workload", tw.WORKLOADS)
def test_zoo_checkpoint_conformance(tmp_path, workload, one_thread):
    """Every ported preset at test size: a step, a save, a restore into a
    state built from another seed (and stepped once, so the optimizer has
    state to overwrite): the state equals the saved one bit for bit, and
    one further step equals the uninterrupted run's."""
    args, (wl, state, step, batches) = _build(workload)
    state, _ = step(state, next(batches))
    mgr = CheckpointManager(tmp_path / "ckpt", async_save=False)
    assert mgr.save(1, state, force=True)
    saved = _fingerprint(state)
    state, m = step(state, next(batches))
    ref_loss, ref_fp = float(m["loss"]), _fingerprint(state)

    _, (_, other, other_step, other_batches) = _build(workload)
    other.model.load_state_dict(wl.init_params(
        wl.cfg, torch.Generator().manual_seed(1)))
    other_step(other, next(other_batches))
    assert _fingerprint(other) != saved
    assert mgr.restore_latest(other) is other
    assert other.step == 1 and _fingerprint(other) == saved
    source = skip_batches(wl.input_fn(InputContext(global_batch_size=8),
                                      args.seed), 1)
    other, m = other_step(other, device_put_batch(next(source), "cpu"))
    assert float(m["loss"]) == ref_loss
    assert _fingerprint(other) == ref_fp
    # what was saved loads with weights_only
    torch.load(tmp_path / "ckpt" / "1" / tmanager.PAYLOAD, weights_only=True)


# ----------------------------------------------------------------- integrity


def _two_steps(tmp_path, **kw):
    state = _lenet_state()
    mgr = CheckpointManager(tmp_path / "ck", async_save=False, **kw)
    for s in (1, 2):
        state, _ = _lenet_step(state, seed=s)
        mgr.save(state.step, state)
    return mgr, state


def _flip_byte(path, offset=None):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2 if offset is None else offset)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


def test_corrupt_newest_step_falls_back(tmp_path, caplog):
    mgr, _ = _two_steps(tmp_path)
    _flip_byte(tmp_path / "ck" / "2" / tmanager.PAYLOAD)
    fresh = _lenet_state(seed=3)
    with caplog.at_level(logging.INFO):
        assert mgr.restore_latest(fresh) is fresh
    assert fresh.step == 1
    report = mgr.last_restore_report
    assert report["restored_step"] == 1
    assert [r["step"] for r in report["rejected"]] == [2]
    assert "restored VERIFIED checkpoint step 1" in caplog.text
    # the same restore from step 1 alone
    again = _lenet_state(seed=4)
    mgr.restore(1, again)
    assert _fingerprint(again) == _fingerprint(fresh)


def test_restore_of_a_corrupt_step_raises_and_does_not_fall_back(tmp_path):
    mgr, _ = _two_steps(tmp_path)
    _flip_byte(tmp_path / "ck" / "2" / tmanager.PAYLOAD)
    fresh = _lenet_state(seed=3)
    before = _fingerprint(fresh)
    with pytest.raises(CheckpointCorruptError):
        mgr.restore(2, fresh)
    assert fresh.step == 0 and _fingerprint(fresh) == before
    with pytest.raises(FileNotFoundError):
        mgr.restore(5, fresh)


def test_truncated_and_misshapen_steps_are_rejected(tmp_path):
    """A truncated payload fails its load; a payload that does not fit
    the target fails before the target changes; every step rejected is a
    cold start."""
    mgr, _ = _two_steps(tmp_path)
    path = tmp_path / "ck" / "2" / tmanager.PAYLOAD
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 3)
    cifar = tw.get_workload("cifar_resnet20", test_size=True)
    other = tt.TrainState.create(cifar.model_cls(cifar.cfg, device="cpu"),
                                 cifar.make_optimizer)
    before = _fingerprint(other)
    assert mgr.restore_latest(other) is None
    reasons = {r["step"]: r["reason"] for r in
               mgr.last_restore_report["rejected"]}
    assert reasons[2].startswith("restore raised")
    assert "names differ" in reasons[1]
    assert _fingerprint(other) == before


def test_manifest_mismatch_is_caught_even_when_the_load_succeeds(tmp_path):
    """A changed byte inside a tensor loads fine; the manifest's CRC
    catches it."""
    mgr, state = _two_steps(tmp_path)
    bad = _lenet_state()
    tree = torch.load(tmp_path / "ck" / "2" / tmanager.PAYLOAD,
                      weights_only=True)
    name = next(iter(tree["params"]))
    tree["params"][name].view(-1)[0] += 1.0
    torch.save(tree, tmp_path / "ck" / "2" / tmanager.PAYLOAD)
    assert mgr.restore_latest(bad).step == 1
    reason = mgr.last_restore_report["rejected"][0]["reason"]
    assert f"params/{name}: checksum mismatch" in reason


def test_a_step_without_its_commit_marker_is_not_a_step(tmp_path, caplog):
    mgr, _ = _two_steps(tmp_path)
    os.remove(tmp_path / "ck" / "2" / tmanager.COMMIT_MARKER)
    os.makedirs(tmp_path / "ck" / "9")  # a save cut before its payload
    with caplog.at_level(logging.WARNING):
        assert mgr.all_steps() == [1]
    assert "no commit marker" in caplog.text
    fresh = _lenet_state(seed=3)
    assert mgr.restore_latest(fresh).step == 1
    assert mgr.last_restore_report["rejected"] == []


def test_manifest_has_jax_fields(tmp_path):
    """The manifest document and its records have JAX's fields, and a
    tensor's CRC equals the one JAX records for the same array."""
    mgr, state = _two_steps(tmp_path)
    doc = integrity.load_manifest(tmp_path / "ck", 2)
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    jax_recs = jax_integrity.tree_checksums({"w": arr})
    jpath = jax_integrity.write_manifest(str(tmp_path / "jax"), 2, jax_recs)
    with open(jpath) as f:
        jdoc = json.load(f)
    assert set(doc) == set(jdoc) == {"version", "step", "t", "arrays"}
    assert doc["version"] == jdoc["version"] == 1 and doc["step"] == 2
    rec = next(r for k, r in doc["arrays"].items()
               if k.startswith("params/"))
    assert set(rec) == set(next(iter(jdoc["arrays"].values())))
    assert rec["dtype"] == "float32" and rec["nbytes"] == 4 * \
        int(np.prod(rec["shape"]))
    assert integrity.tensor_record(torch.from_numpy(arr)) == \
        next(iter(jax_recs.values()))
    keys = set(doc["arrays"])
    assert "step" in keys and "opt_state/param_groups/0/count" in keys
    assert any(k.startswith("opt_state/state/") for k in keys)
    assert integrity.tensor_record(torch.ones(2, dtype=torch.bfloat16))[
        "dtype"] == "bfloat16"


def test_async_save_holds_the_state_of_its_step(tmp_path):
    """save() returns once the state is on the host: an update made while
    the write is in flight does not reach the checkpoint."""
    state = _lenet_state()
    mgr = CheckpointManager(tmp_path / "ck")
    assert mgr.save(0, state)
    saved = _fingerprint(state)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    mgr.wait()
    fresh = _lenet_state(seed=5)
    mgr.restore_latest(fresh)
    assert _fingerprint(fresh) == saved


def test_a_failed_write_raises_at_the_next_wait(tmp_path, monkeypatch):
    state = _lenet_state()
    mgr = CheckpointManager(tmp_path / "ck")

    def broken(*args, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(tmanager.torch, "save", broken)
    assert mgr.save(1, state)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.all_steps() == []
    mgr.save(2, state)
    time.sleep(0.05)
    with pytest.raises(OSError, match="disk full"):
        mgr.save(3, state)


# --------------------------------------------------------------- exact resume


def _dropout_gpt(monkeypatch, rate=0.1):
    make = train_torch.get_workload

    def with_dropout(*args, **kw):
        wl = make(*args, **kw)
        return dataclasses.replace(wl, cfg=dataclasses.replace(
            wl.cfg, dropout_rate=rate))

    monkeypatch.setattr(train_torch, "get_workload", with_dropout)


def test_gpt_lm_resumes_bit_for_bit(tmp_path, monkeypatch, one_thread):
    """gpt_lm at test size, dropout 0.1, two microbatches a step: 4 steps
    uninterrupted against 2, an async save, a restore into a state built
    from another seed, and 2 more: losses and fingerprint bit for bit."""
    _dropout_gpt(monkeypatch)
    argv = ["--workload", "gpt_lm", "--test-size", "--device", "cpu",
            "--accum-steps", "2"]
    args = train_torch.parse_args(argv)
    wl, state, step, batches = train_torch.build(args)
    assert wl.cfg.dropout_rate == 0.1
    losses = [float(step(state, next(batches))[1]["loss"]) for _ in range(4)]
    ref = _fingerprint(state)

    wl, state, step, batches = train_torch.build(args)
    got = [float(step(state, next(batches))[1]["loss"]) for _ in range(2)]
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(state.step, state)
    mgr.close()

    _, fresh, step, _ = train_torch.build(train_torch.parse_args(
        argv + ["--seed", "1"]))
    step = tt.make_train_step(wl.loss_fn(fresh.model), accum_steps=2,
                              seed=0)
    assert mgr.restore_latest(fresh).step == 2
    source = skip_batches(wl.input_fn(InputContext(global_batch_size=8), 0),
                          2)
    got += [float(step(fresh, device_put_batch(next(source), "cpu"))[1]
                  ["loss"]) for _ in range(2)]
    assert got == losses
    assert _fingerprint(fresh) == ref


def test_train_torch_resumes_from_its_checkpoint_dir(tmp_path, caplog,
                                                     one_thread, capsys):
    """``--checkpoint-dir``: a run of 2 steps, then the same command with
    ``--steps 4`` restores step 2, fast-forwards 2 batches and logs the
    losses of steps 3 and 4 of an uninterrupted run."""
    argv = ["--workload", "gpt_lm", "--test-size", "--device", "cpu",
            "--log-every", "1"]
    ref = train_torch.main(argv + ["--steps", "4"])
    ck = ["--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "1"]
    first = train_torch.main(argv + ck + ["--steps", "2"])
    assert [r["step"] for r in first] == [1, 2]
    with caplog.at_level(logging.INFO):
        rest = train_torch.main(argv + ck + ["--steps", "4"])
    assert "restored checkpoint step 2" in caplog.text
    assert "fast-forwarding input 2 batches" in caplog.text
    assert [r["step"] for r in rest] == [3, 4]
    assert [r["loss"] for r in first + rest] == [r["loss"] for r in ref]
    assert CheckpointManager(tmp_path / "ck").all_steps() == [2, 3, 4]
    # a finished run reruns to nothing
    assert train_torch.main(argv + ck + ["--steps", "4"]) == []


@pytest.fixture
def sigterm_guard():
    """Whatever the test does, SIGTERM does not end the test process:
    ``(notices this handler saw, the handler)``."""
    seen = []

    def guard(*notice):
        seen.append(notice)

    prev = signal.signal(signal.SIGTERM, guard)
    yield seen, guard
    signal.signal(signal.SIGTERM, prev)


def test_sigterm_stops_at_a_step_boundary_with_a_saved_step(
        tmp_path, monkeypatch, sigterm_guard, caplog):
    """SIGTERM sent to this process during step 2 of 6: the run saves
    step 2, stops there with its records so far, and puts the previous
    handler back; the rerun trains steps 3-6."""
    build = train_torch.build

    def signalling_build(args, checkpointer=None):
        wl, state, step, batches = build(args, checkpointer)

        def step_and_signal(state, batch):
            state, metrics = step(state, batch)
            if state.step == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return state, metrics

        return wl, state, step_and_signal, batches

    monkeypatch.setattr(train_torch, "build", signalling_build)
    argv = ["--workload", "gpt_lm", "--test-size", "--device", "cpu",
            "--log-every", "1", "--steps", "6",
            "--checkpoint-dir", str(tmp_path / "ck")]
    with caplog.at_level(logging.WARNING):
        records = train_torch.main(argv)
    assert [r["step"] for r in records] == [1, 2]
    assert CheckpointManager(tmp_path / "ck").all_steps() == [2]
    assert "preemption save complete at step 2" in caplog.text
    seen, guard = sigterm_guard
    assert seen == []  # the port's handler took it
    assert signal.getsignal(signal.SIGTERM) is guard
    monkeypatch.setattr(train_torch, "build", build)
    assert [r["step"] for r in train_torch.main(argv)] == [3, 4, 5, 6]


# ------------------------------------------------------------ across packages


def _orbax_numpy(directory, step, like):
    """A JAX package checkpoint read with orbax into numpy (``like``: the
    tree the JAX manager saved, for its structure)."""
    mgr = ocp.CheckpointManager(
        directory, item_handlers=ocp.StandardCheckpointHandler())
    tree = mgr.restore(step, args=ocp.args.StandardRestore(like))
    mgr.close()
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """JAX trains gpt_lm (test size, fp32, AdamW with clipping and a
    warm-up cosine) for 2 steps and saves through its own manager; the
    port carries the file over (``params_from_flax``,
    ``opt_state_from_optax``) and takes step 3: its loss within 1e-5
    relative of JAX's step 3, the parameters within 1e-5 of their max-abs.
    The optimizer state converts back to JAX's exactly."""
    jw = jax_workloads.get_workload("gpt_lm", test_size=True)
    pw = tw.get_workload("gpt_lm", test_size=True)
    jcfg = dataclasses.replace(jw.model.cfg, dtype=jnp.float32)
    tcfg = dataclasses.replace(pw.cfg, dtype=torch.float32)
    jlr = jax_optimizers.build_schedule("cosine", 1e-3, warmup_steps=1,
                                        total_steps=6)
    tx = jax_optimizers.build_optimizer("adamw", jlr, weight_decay=0.1,
                                        global_clipnorm=1.0)
    params = jax.jit(JaxGPTLM(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 64), jnp.int32))["params"]
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           model_state={}, opt_state=tx.init(params), tx=tx)
    jstep = jax.jit(_step_body(jax_lm_loss(JaxGPTLM(jcfg)), 1))
    src = jw.input_fn(JaxInputContext(global_batch_size=8), 0)
    batches = [next(src) for _ in range(3)]
    for b in batches[:2]:
        jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                          jax.random.PRNGKey(0))
    jmgr = JaxCheckpointManager(str(tmp_path / "jax"), async_save=False)
    assert jmgr.save(2, jstate, force=True)
    jmgr.wait()
    jmgr.close()
    like = {"step": jstate.step, "params": jstate.params, "model_state": {},
            "opt_state": jstate.opt_state}
    saved = _orbax_numpy(str(tmp_path / "jax"), 2, like)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                for k, v in batches[2].items()},
                       jax.random.PRNGKey(0))

    model = tm.GPTLM(tcfg, device="cpu")
    model.load_state_dict(tm.params_from_flax(saved["params"], tcfg))
    tlr = tt.build_schedule("cosine", 1e-3, warmup_steps=1, total_steps=6)
    opt = tt.build_optimizer("adamw", tlr, weight_decay=0.1,
                             global_clipnorm=1.0)(model.named_parameters())
    opt.load_state_dict(tm.opt_state_from_optax(saved["opt_state"], tcfg,
                                                opt, model))
    state = tt.TrainState(int(saved["step"]), model, opt)
    back = tm.opt_state_to_optax(opt, tcfg, model, saved["opt_state"])
    jl, jd = jax.tree_util.tree_flatten(saved["opt_state"])
    bl, bd = jax.tree_util.tree_flatten(back)
    assert jd == bd
    for a, b in zip(jl, bl):
        np.testing.assert_array_equal(np.asarray(b), a)

    step = tt.make_train_step(tm.lm_loss(model))
    state, m = step(state, {k: torch.as_tensor(v, dtype=torch.long)
                            for k, v in batches[2].items()})
    assert state.step == 3 and opt.param_groups[0]["count"] == 3
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    got = dict(_flat(tm.params_to_flax(model.state_dict(), tcfg)))
    for path, ref in _flat(jax.tree.map(np.asarray, jstate.params)):
        np.testing.assert_allclose(got[path], ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg="/".join(path))


#: optimizer, schedule, warmup, weight decay, clipnorm, decay mask
CONVERT_CASES = {
    "sgd": ("sgd", "constant", 0, 0.0, 0.0, False),
    "momentum_cosine": ("momentum", "cosine", 1, 0.0, 0.0, False),
    "adam_linear_clip": ("adam", "linear", 1, 0.0, 1.0, False),
    "adamw_cosine_clip_mask": ("adamw", "cosine", 0, 0.1, 0.5, True),
    "adagrad_warmup": ("adagrad", "constant", 2, 0.0, 0.0, False),
}


@pytest.mark.parametrize("case", sorted(CONVERT_CASES))
def test_opt_state_converters_match_optax(case):
    """Each ported optimizer on gpt_tiny's parameters: two optax updates,
    the state carried into the port, one more update on each side
    (parameters within 1e-6), and JAX -> port -> JAX exact."""
    name, sched, warmup, wd, clip, masked = CONVERT_CASES[case]
    cfg = tm.gpt_tiny()
    model = tm.GPTLM(cfg, device="cpu")
    model.load_state_dict(tm.init_params(cfg, torch.Generator().manual_seed(0)))
    jp = tm.params_to_flax(model.state_dict(), cfg)
    rng = np.random.default_rng(2)
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), jp) for _ in range(3)]
    tx = jax_optimizers.build_optimizer(
        name, jax_optimizers.build_schedule(sched, 0.05, warmup_steps=warmup,
                                            total_steps=5),
        weight_decay=wd, global_clipnorm=clip,
        decay_mask=(jax_optimizers.exclude_bias_and_norm_mask if masked
                    else None))
    js = tx.init(jp)
    for g in grads[:2]:
        upd, js = tx.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
    model.load_state_dict(tm.params_from_flax(jp, cfg))
    opt = tt.build_optimizer(
        name, tt.build_schedule(sched, 0.05, warmup_steps=warmup,
                                total_steps=5),
        weight_decay=wd, global_clipnorm=clip,
        decay_mask=tt.exclude_bias_and_norm_mask if masked else None)(
        model.named_parameters())
    opt.load_state_dict(tm.opt_state_from_optax(js, cfg, opt, model))
    back = tm.opt_state_to_optax(opt, cfg, model, js)
    jl, jd = jax.tree_util.tree_flatten(js)
    bl, bd = jax.tree_util.tree_flatten(back)
    assert jd == bd
    for a, b in zip(jl, bl):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))

    upd, js = tx.update(grads[2], js, jp)
    jp = optax.apply_updates(jp, upd)
    grads_port = tm.params_from_flax(grads[2], cfg)
    for n, p in model.named_parameters():
        p.grad = grads_port[n].clone()
    opt.step()
    got = dict(_flat(tm.params_to_flax(model.state_dict(), cfg)))
    for path, ref in _flat(jp):
        np.testing.assert_allclose(got[path], ref, rtol=0, atol=1e-6,
                                   err_msg="/".join(path))


# --------------------------------------------------------------------- ranks


def test_chief_writes_and_ranks_restore_alike(tmp_path, monkeypatch):
    """Two thread ranks save one forced step into one directory: rank 0
    alone writes; after the barrier both restore it into states built from
    their own seeds and hold equal state, the chief's."""
    writers = []
    write = CheckpointManager._write

    def recording_write(self, *args):
        writers.append(collectives.group_rank(self._mesh))
        return write(self, *args)

    monkeypatch.setattr(CheckpointManager, "_write", recording_write)

    def body(rank, group):
        mgr = CheckpointManager(tmp_path / "ck", mesh=group)
        state = _lenet_state(seed=rank)
        state.step = 3
        saved = _fingerprint(state)
        assert mgr.save(3, state, force=True)
        fresh = _lenet_state(seed=10 + rank)
        mgr.restore_latest(fresh)
        mgr.close()
        return saved, _fingerprint(fresh)

    (chief, got0), (_, got1) = run_ranks(body, 2)
    assert writers == [0]
    assert got0 == got1 == chief


def test_should_save_agrees_across_ranks(tmp_path):
    """Only rank 1 is triggered (before step 4): with ``poll_every`` 3
    both ranks answer False until the poll step 6 and True there."""
    def body(rank, group):
        handler = PreemptionHandler(CheckpointManager(tmp_path, mesh=group),
                                    mesh=group, poll_every=3)
        answers = []
        for s in range(8):
            if rank == 1 and s == 4:
                handler.trigger()
            answers.append(handler.should_save(s))
        return answers

    want = [False] * 6 + [True, False]
    assert run_ranks(body, 2) == [want, want]


# --------------------------------------------------------------------- utils


def test_derive_seed_matches_jax():
    for base in (0, 1, 7, 2**31 - 1, -3):
        for names in ((), ("shuffle",), ("shuffle", 3), ("dropout", 0, 12),
                      (5,), ("a", "b", "c", 9)):
            assert derive_seed(base, *names) == \
                jax_determinism.derive_seed(base, *names)


def test_tree_fingerprint_is_stable_and_sees_one_bit():
    g = torch.Generator().manual_seed(0)
    tree = {"b": torch.randn(3, 4, generator=g).to(torch.bfloat16),
            "a": {"w": torch.randn(5, generator=g), "n": 3},
            "opt": [torch.zeros(2, dtype=torch.int64), None]}
    fp = tree_fingerprint(tree)
    assert fp == tree_fingerprint(dict(reversed(list(tree.items()))))
    assert fp == tree_fingerprint({k: v for k, v in tree.items()})
    flipped = tree["b"].clone()
    flipped.view(torch.int16).view(-1)[5] ^= 1
    assert tree_fingerprint({**tree, "b": flipped}) != fp
    assert tree_fingerprint({**tree, "b": tree["b"].float()}) != fp


def test_watchdog_fires_on_a_missed_ping(capsys):
    fired = threading.Event()
    with Watchdog(0.2, on_timeout=fired.set, poll_interval=0.02) as wd:
        wd.ping()
        assert not wd.fired
        assert fired.wait(5.0)
        assert wd.fired and wd.ping_age() >= 0.2
        wd.ping()
        assert not wd.fired
    assert "--- thread" in capsys.readouterr().err


def test_skip_batches_on_a_short_stream_logs_and_stops(caplog):
    it = iter(range(3))
    with caplog.at_level(logging.WARNING):
        assert skip_batches(it, 5) is it
    assert "input exhausted after skipping 3/5 batches" in caplog.text
    it = iter(range(10))
    assert next(skip_batches(it, 4)) == 4


def test_enable_determinism_sets_the_switches(monkeypatch):
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark,
              torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    try:
        enable_determinism()
        enable_determinism()  # idempotent
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.backends.cudnn.deterministic
        assert not torch.backends.cudnn.benchmark
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    finally:
        torch.use_deterministic_algorithms(before[0])
        torch.backends.cudnn.deterministic = before[1]
        torch.backends.cudnn.benchmark = before[2]
        torch.backends.cuda.matmul.allow_tf32 = before[3]
        torch.backends.cudnn.allow_tf32 = before[4]


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(32, 32)
    with trace(str(tmp_path / "prof")):
        with annotate("ckpt_test_region"):
            (x @ x).sum()
    with open(tmp_path / "prof" / "trace.json") as f:
        doc = json.load(f)
    assert any(e.get("name") == "ckpt_test_region"
               for e in doc["traceEvents"])
