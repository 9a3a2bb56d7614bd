"""The port's multi-step calls against the JAX package's, and what feeds
them: device-seeded dropout, the optimizer's rate table, the Trainer's
bundled fit loop and ``train_torch.py --steps-per-call``.

- **Against JAX**: ``make_multi_train_step`` (k = 3; on the CPU a loop of
  single steps) against the JAX ``make_multi_train_step`` on a one-device
  mesh, from one init and on the same bundles, for gpt_lm at test size
  (fp32, AdamW with warm-up, cosine decay and clipping; one and two
  microbatches), mnist_lenet (the JAX engine test's LeNet-5 and momentum
  SGD), cifar_resnet20 (BatchNorm statistics), and imagenet_vit and
  t5_seq2seq (their models in fp32).  Two calls: the stacked
  losses within 1e-5 relative (the tolerance of
  ``tests/test_torch_train.py::test_train_steps_match_jax``), the
  parameters after six updates within 1e-3 of a leaf's max-abs and the
  running statistics within 1e-4 (those of
  ``tests/test_torch_baseline.py::test_train_steps_match_jax``, whose
  ResNet-20 exception applies here too: JAX's gradient of one BatchNorm
  channel strays 6% at its second step, so ResNet-20 runs one call, the
  three steps that test holds, and its parameters are left out).  Two
  thread ranks over
  gloo at k = 2 against JAX's multi step on the global batch.
- **Against the single step**: k steps a call equal k single steps bit
  for bit, with dropout and accumulation; ``steps_per_call=1`` is the
  single step.
- **The Trainer**: a prebundled short tail is trained, bundles fire hooks
  on boundary crossings, and a resume at an unaligned step is exact.

fp32 unless a test says otherwise.  The JAX package is only called.
"""

import dataclasses
import io
import json
import os
import subprocess
import sys

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
from distributedtensorflow_tpu.models import seq2seq as jax_s2s
from distributedtensorflow_tpu.models import vit as jax_vit
from distributedtensorflow_tpu.parallel import MeshSpec as JaxMeshSpec
from distributedtensorflow_tpu.parallel import build_mesh as jax_build_mesh
from distributedtensorflow_tpu.train import create_sharded_state
from distributedtensorflow_tpu.train import losses as jax_losses
from distributedtensorflow_tpu.train import (
    make_multi_train_step as jax_multi_step,
)
from distributedtensorflow_tpu.train import optimizers as jax_optimizers
from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch import train as tt
from distributedtensorflow_tpu_torch import workloads as tw
from distributedtensorflow_tpu_torch.checkpoint import CheckpointManager
from distributedtensorflow_tpu_torch.data import (
    InputContext,
    device_put_batch,
    device_put_bundle,
)
from distributedtensorflow_tpu_torch.models.layers import (
    DropoutKey,
    draw_seed,
    dropout,
)
from distributedtensorflow_tpu_torch.ops import dropout as dmod
from distributedtensorflow_tpu_torch.parallel.mesh import MeshSpec, build_mesh
from distributedtensorflow_tpu_torch.testing import run_ranks
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
PARAM_TOL = 1e-3
STATS_TOL = 1e-4
K = 3
CALLS = 2


def _flat(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def _assert_trees_close(got, ref, rel):
    got, ref = dict(_flat(got)), dict(_flat(ref))
    assert got.keys() == ref.keys()
    for path, r in ref.items():
        np.testing.assert_allclose(got[path], r, rtol=0,
                                   atol=rel * np.abs(r).max(),
                                   err_msg="/".join(path))


def _stack(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _torch_bundle(bundle):
    return {k: torch.as_tensor(v, dtype=torch.long if v.dtype.kind in "iu"
                               else None) for k, v in bundle.items()}


def _schedule(pkg):
    return pkg.build_schedule("cosine", 1e-3, warmup_steps=2,
                              total_steps=K * CALLS)


def _gpt_case(accum):
    jcfg = dataclasses.replace(jax_gpt_tiny(), dtype=jnp.float32)
    pw = tw.get_workload("gpt_lm", test_size=True)
    tcfg = dataclasses.replace(pw.cfg, dtype=torch.float32)
    variables = jax.device_get(jax.jit(JaxGPTLM(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 64), jnp.int32)))
    model = tm.GPTLM(tcfg, device="cpu")
    model.load_state_dict(tm.params_from_flax(variables["params"], tcfg))
    jtx = jax_optimizers.build_optimizer(
        "adamw", _schedule(jax_optimizers), weight_decay=0.1,
        global_clipnorm=1.0)
    make = tt.build_optimizer("adamw", _schedule(tt), weight_decay=0.1,
                              global_clipnorm=1.0)
    return dict(variables=variables, jloss=jax_lm_loss(JaxGPTLM(jcfg)),
                jtx=jtx, model=model, loss=tm.lm_loss(model), make=make,
                source=pw.input_fn, accum=accum, cfg=tcfg)


def _baseline_case(name):
    jw = jax_workloads.get_workload(name, test_size=True, global_batch_size=8)
    pw = tw.get_workload(name, test_size=True, global_batch_size=8)
    variables = jax.device_get(jw.init_fn(jax.random.PRNGKey(6)))
    model = pw.model_cls(pw.cfg, device="cpu")
    model.load_state_dict(tm.params_from_flax(variables, pw.cfg))
    return dict(variables=variables, jloss=jw.loss_fn,
                jtx=jw.make_optimizer(), model=model,
                loss=pw.loss_fn(model), make=pw.make_optimizer,
                source=pw.input_fn, accum=1, cfg=pw.cfg)


def _fp32_preset_case(name):
    """imagenet_vit or t5_seq2seq at test size (global batch 8), both
    packages' models in fp32 (the presets compute in bf16)."""
    jw = jax_workloads.get_workload(name, test_size=True, global_batch_size=8)
    pw = tw.get_workload(name, test_size=True, global_batch_size=8)
    jcfg = dataclasses.replace(jw.model.cfg, dtype=jnp.float32)
    if name == "imagenet_vit":
        jmodel = jax_vit.ViT(jcfg)
        jloss = jax_losses.classification_loss(jmodel)
        init_args = (jnp.zeros((2, 32, 32, 3)),)
    else:
        jmodel = jax_s2s.Seq2SeqLM(jcfg)
        jloss = jax_s2s.seq2seq_loss(jmodel)
        init_args = (jnp.zeros((2, pw.seq_len), jnp.int32),) * 2
    variables = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(6),
                                                    *init_args))
    cfg = dataclasses.replace(pw.cfg, dtype=torch.float32)
    model = pw.model_cls(cfg, device="cpu")
    model.load_state_dict(tm.params_from_flax(variables, cfg))
    return dict(variables=variables, jloss=jloss, jtx=jw.make_optimizer(),
                model=model, loss=pw.loss_fn(model), make=pw.make_optimizer,
                source=pw.input_fn, accum=1, cfg=cfg)


MULTI_CASES = {"gpt_lm_accum1": lambda: _gpt_case(1),
               "gpt_lm_accum2": lambda: _gpt_case(2),
               "mnist_lenet": lambda: _baseline_case("mnist_lenet"),
               "cifar_resnet20": lambda: _baseline_case("cifar_resnet20"),
               "imagenet_vit": lambda: _fp32_preset_case("imagenet_vit"),
               "t5_seq2seq": lambda: _fp32_preset_case("t5_seq2seq")}


@pytest.mark.parametrize("case", sorted(MULTI_CASES))
def test_multi_step_matches_jax(case, devices):
    """Two calls of three steps (ResNet-20: one) through both packages'
    multi-step functions: stacked (3,) losses each call, parameters and
    running statistics after the updates."""
    c = MULTI_CASES[case]()
    mesh = jax_build_mesh(JaxMeshSpec(data=1), devices[:1])
    jstate, specs = create_sharded_state(lambda r: c["variables"], c["jtx"],
                                         mesh, jax.random.PRNGKey(0))
    jstep = jax_multi_step(c["jloss"], mesh, specs, steps_per_call=K,
                           accum_steps=c["accum"], donate=False)
    model = c["model"]
    state = tt.TrainState(0, model, c["make"](list(model.named_parameters())))
    step = tt.make_multi_train_step(c["loss"], steps_per_call=K,
                                    accum_steps=c["accum"])
    src = c["source"](InputContext(global_batch_size=8), 0)
    calls = 1 if case == "cifar_resnet20" else CALLS
    for _ in range(calls):
        bundle = _stack([next(src) for _ in range(K)])
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in bundle.items()},
                           jax.random.PRNGKey(0))
        state, m = step(state, _torch_bundle(bundle))
        assert m["loss"].shape == (K,) and m.keys() == jm.keys()
        for k in m:
            np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]),
                                       rtol=RTOL, atol=1e-7, err_msg=k)
    assert state.step == int(jstate.step) == K * calls
    got = tm.params_to_flax(model.state_dict(), c["cfg"])
    ref = jax.device_get({"params": jstate.params, **jstate.model_state})
    if "batch_stats" in ref:
        _assert_trees_close(got["batch_stats"], ref["batch_stats"],
                            STATS_TOL)
    if case != "cifar_resnet20":
        _assert_trees_close(got.get("params", got), ref["params"], PARAM_TOL)


def test_multi_step_over_thread_ranks_matches_jax(devices):
    """Two thread ranks over gloo, k = 2, two calls, gpt_lm with two
    microbatches: each rank's stacked losses equal JAX's multi step on
    the global batch (the ranks' pipelines, rank-major) within 1e-5, and
    the ranks hold one replica bit for bit."""
    world, k, accum = 2, 2, 2
    c = _gpt_case(accum)
    mesh = jax_build_mesh(JaxMeshSpec(data=1), devices[:1])
    jstate, specs = create_sharded_state(lambda r: c["variables"], c["jtx"],
                                         mesh, jax.random.PRNGKey(0))
    jstep = jax_multi_step(c["jloss"], mesh, specs, steps_per_call=k,
                           accum_steps=accum, donate=False)
    srcs = [c["source"](InputContext(world, r, 8), 0) for r in range(world)]
    hosts = [[[next(s) for _ in range(k)] for _ in range(CALLS)]
             for s in srcs]
    ref = []
    for call in range(CALLS):
        glob = [{name: np.concatenate([hosts[r][call][i][name]
                                       for r in range(world)])
                 for name in hosts[0][call][i]} for i in range(k)]
        jstate, jm = jstep(jstate, {n: jnp.asarray(v)
                                    for n, v in _stack(glob).items()},
                           jax.random.PRNGKey(0))
        ref.append(np.asarray(jm["loss"]))
    state_dict = c["model"].state_dict()

    def body(rank, group):
        tmesh = build_mesh(MeshSpec(data=world), group)
        model = tm.GPTLM(c["cfg"], device="cpu")
        model.load_state_dict(state_dict)
        state = tt.TrainState.create(model, c["make"], tmesh)
        step = tt.make_multi_train_step(
            tm.lm_loss(model, group=tmesh), steps_per_call=k,
            accum_steps=accum, mesh=tmesh)
        losses = []
        for call in range(CALLS):
            bundle = device_put_bundle(hosts[rank][call], "cpu", tmesh,
                                       accum_steps=accum)
            state, m = step(state, bundle)
            losses.append(m["loss"].numpy())
        return losses, model.state_dict()

    outs = run_ranks(body, world)
    for losses, _ in outs:
        for got, want in zip(losses, ref):
            np.testing.assert_allclose(got, want, rtol=RTOL)
    for name, t in outs[0][1].items():
        assert torch.equal(t, outs[1][1][name]), name


def _gpt_dropout_state(seed=3):
    cfg = dataclasses.replace(tm.gpt_tiny(), dtype=torch.float32,
                              dropout_rate=0.1)
    model = tm.GPTLM(cfg, device="cpu")
    model.load_state_dict(tm.init_params(cfg, torch.Generator()
                                         .manual_seed(seed)))
    make = tt.build_optimizer("adamw", _schedule(tt), weight_decay=0.1,
                              global_clipnorm=1.0)
    return tt.TrainState(0, model, make(list(model.named_parameters())))


@pytest.fixture(scope="module")
def single_steps():
    """Six single steps of :func:`_gpt_dropout_state` on fixed ids (two
    microbatches, seed 7): ``(ids, the state after, the losses)``, built
    once for every k of :func:`test_multi_step_equals_single_steps`."""
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, 512, (6, 4, 32)))
    ref = _gpt_dropout_state()
    single = tt.make_train_step(tm.lm_loss(ref.model), accum_steps=2, seed=7)
    want = []
    for i in range(6):
        ref, m = single(ref, {"input_ids": ids[i]})
        want.append(m["loss"])
    return ids, ref, want


@pytest.mark.parametrize("k", [1, 3])
def test_multi_step_equals_single_steps(k, single_steps):
    """gpt_lm at test size with dropout 0.1, two microbatches, AdamW on
    a warm-up cosine with clipping: six steps k a call equal six single
    steps bit for bit (losses, parameters, the optimizer's moments and
    count); k = 1 is the single step itself."""
    ids, ref, want = single_steps
    state = _gpt_dropout_state()
    multi = tt.make_multi_train_step(tm.lm_loss(state.model),
                                     steps_per_call=k, accum_steps=2, seed=7)
    got = []
    for i in range(0, 6, k):
        if k == 1:
            state, m = multi(state, {"input_ids": ids[i]})
            got.append(m["loss"])
        else:
            state, m = multi(state, {"input_ids": ids[i:i + k]})
            assert m["loss"].shape == (k,)
            got.extend(m["loss"])
    assert torch.equal(torch.stack(got), torch.stack(want))
    assert state.step == ref.step == 6
    for a, b in zip(state.model.parameters(), ref.model.parameters()):
        assert torch.equal(a, b)
    sa, sb = state.optimizer.state_dict(), ref.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for key, val in st.items():
            assert torch.equal(val, sb["state"][i][key]), (i, key)
    assert sa["param_groups"][0]["count"] == 6
    if k == 1:
        assert type(multi).__name__ == "_InstrumentedStep" \
            and multi._label == "train_step"


def test_multi_step_refuses_oversized_bundles():
    state = _gpt_dropout_state()
    multi = tt.make_multi_train_step(tm.lm_loss(state.model),
                                     steps_per_call=2)
    with pytest.raises(ValueError, match="steps_per_call=2"):
        multi(state, {"input_ids": torch.zeros((3, 2, 16), dtype=torch.long)})


# --------------------------------------------------------------- dropout


def test_dropout_mask_is_philox_of_seed_site_and_index():
    """The plain version is Philox4x32-10 (the Random123 test vector of
    counter 0 and key 0), keeps 1 - rate of the elements within 4 sigma,
    scales the kept ones by 1 / float32(1 - rate), and draws another mask
    for another site or seed; the backward applies the same mask."""
    words = dmod.philox4x32(torch.zeros(1, 4, dtype=torch.int64), (0, 0))
    assert [int(w) for w in words[0]] == [0x6627E8D5, 0xE169C58D,
                                          0xBC57AC4C, 0x9B00DBD8]
    x = torch.randn(64, 1000, dtype=torch.float32, requires_grad=True)
    rate = 0.1
    out = dropout(x, rate, (12345, 2))
    keep = dmod.keep_mask(x.shape, 12345, 2, rate)
    sigma = (rate * (1 - rate) / x.numel()) ** 0.5
    assert abs(float(keep.float().mean()) - (1 - rate)) < 4 * sigma
    scale = float(torch.tensor(1 - rate, dtype=torch.float32))
    assert torch.equal(out, torch.where(keep, x / scale, 0.0))
    assert not torch.equal(keep, dmod.keep_mask(x.shape, 12345, 3, rate))
    assert not torch.equal(keep, dmod.keep_mask(x.shape, 12346, 2, rate))
    out.sum().backward()
    assert torch.equal(x.grad, torch.where(keep, 1 / scale, 0.0))
    with pytest.raises(ValueError, match="rate"):
        dmod.threshold(1.0)


def test_dropout_keys_draw_the_same_bits_at_k1_and_k3():
    """A step's dropout draws from its microbatches' seeds
    (``step_seed(seed, step, micro, rank)``) and a site count per
    forward, so a bf16 mask of step 5, microbatch 1, equals whether the
    step ran alone or third of a call, and differs between steps and
    ranks; a key hands out sites in order."""
    x = torch.ones(4, 256, dtype=torch.bfloat16)
    key = tt.dropout_keys(7, 5, 2)[1]
    assert key.seed == tt.step_seed(7, 5, 1)
    assert draw_seed(key) == (key.seed, 0) and draw_seed(key) == (key.seed, 1)
    a = dropout(x, 0.5, DropoutKey(tt.step_seed(7, 5, 1)).draw())
    b = dropout(x, 0.5, (tt.step_seed(7, 5, 1), 0))
    assert torch.equal(a, b)
    assert not torch.equal(a, dropout(x, 0.5, (tt.step_seed(7, 6, 1), 0)))
    assert not torch.equal(a, dropout(x, 0.5,
                                      (tt.step_seed(7, 5, 1, rank=1), 0)))
    assert isinstance(draw_seed(torch.Generator().manual_seed(0)), int)


# -------------------------------------------------------------- optimizer


def test_rates_follow_build_schedule_and_count_advances():
    """``schedule_rates`` reads ``build_schedule``'s rates (as optax's,
    tests/test_torch_train.py::test_build_schedule_matches_optax), the
    count advances by k through ``TrainState.advance`` and survives
    ``state_dict``; on the CPU the groups' lr stays a float."""
    sched = _schedule(tt)
    jsched = _schedule(jax_optimizers)
    p = [("w", torch.nn.Parameter(torch.ones(3)))]
    opt = tt.build_optimizer("adamw", sched, weight_decay=0.1)(p)
    assert opt.rates is None
    rates = tt.optimizers.schedule_rates(opt, 4)
    np.testing.assert_allclose(rates, [float(jsched(i)) for i in range(4)],
                               rtol=1e-6, atol=1e-9)
    state = tt.TrainState(0, torch.nn.Linear(1, 1), opt)
    state.advance(3)
    assert state.step == 3 and opt.param_groups[0]["count"] == 3
    assert opt.param_groups[0]["lr"] == sched(2)
    buf = io.BytesIO()
    torch.save(opt.state_dict(), buf)
    buf.seek(0)
    opt2 = tt.build_optimizer("adamw", sched, weight_decay=0.1)(
        [("w", torch.nn.Parameter(torch.ones(3)))])
    opt2.load_state_dict(torch.load(buf))
    assert tt.optimizers.schedule_rates(opt2, 2) == [sched(3), sched(4)]
    # a preset optimizer without optax's chain head keeps its constant
    plain = tt.adamw([torch.nn.Parameter(torch.ones(2))], 3e-4)
    assert tt.optimizers.schedule_rates(plain, 2) is None


@pytest.mark.parametrize("name", ["sgd", "momentum", "adagrad"])
def test_written_out_optimizers_take_a_tensor_rate(name):
    """SGD, nesterov momentum and adagrad read a one-element tensor rate
    (what a CUDA graph reads) and give the float rate's update."""
    g = torch.randn(5)

    def run(as_tensor):
        p = torch.nn.Parameter(torch.linspace(-1, 1, 5))
        opt = tt.build_optimizer(name, 0.1)([("p", p)])
        if as_tensor:
            opt.rates = tt.optimizers.RateTable("cpu")
        for _ in range(3):
            p.grad = g.clone()
            opt.step()
        return p.detach()

    torch.testing.assert_close(run(True), run(False), rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ the Trainer


def _lenet():
    pw = tw.get_workload("mnist_lenet", test_size=True, global_batch_size=16)
    model = pw.model_cls(pw.cfg, device="cpu")
    model.load_state_dict(pw.init_params(pw.cfg,
                                         torch.Generator().manual_seed(0)))
    state = tt.TrainState(0, model, tt.sgd(list(model.named_parameters()),
                                           0.05, momentum=0.9))
    return pw, state


def _host_batches(pw, n, seed=0):
    src = pw.input_fn(InputContext(global_batch_size=16), seed)
    return [next(src) for _ in range(n)]


def _rows(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_prebundled_short_tail_is_trained(tmp_path):
    """Twin of ``tests/test_trainer.py::test_prebundled_short_tail_is_
    trained``: a prebundled tail shorter than steps_per_call is trained
    (steps 4-5 logged), and the stream's end surfaces on the next fetch."""
    pw, state = _lenet()
    multi = tt.make_multi_train_step(pw.loss_fn(state.model),
                                     steps_per_call=3)
    cfg = tt.TrainerConfig(total_steps=6, steps_per_call=3,
                           input_prebundled=True, log_every=1,
                           global_batch_size=16, logdir=str(tmp_path))
    batches = _host_batches(pw, 5)

    def bundles():
        yield device_put_bundle(batches[:3], "cpu")
        yield device_put_bundle(batches[3:5], "cpu")

    with tt.Trainer(multi, cfg) as trainer:
        with pytest.raises(StopIteration):
            trainer.fit(state, bundles())
    assert [r["step"] for r in _rows(tmp_path / "metrics.jsonl")] == [3, 5]
    assert state.step == 5


class _Hooks(tt.Callback):
    def __init__(self):
        self.logs, self.evals, self.ckpts, self.steps = [], [], [], []

    def on_step_end(self, trainer, step, state, metrics):
        self.steps.append(step)

    def on_log(self, trainer, step, record):
        self.logs.append(step)

    def on_eval_end(self, trainer, step, state, metrics):
        self.evals.append(step)

    def on_checkpoint(self, trainer, step, state):
        self.ckpts.append(step)


def test_steps_per_call_bundles_dispatches(tmp_path):
    """Twin of ``tests/test_trainer.py::test_steps_per_call_bundles_
    dispatches``, k = 3 over 10 steps (the last call a tail of 1): the
    loop takes three batches a call (stacked by the loop), log, eval and
    checkpoint hooks fire on boundary crossings of 4 (calls ending at 6,
    9, and 10, the last step), total_steps is exact, and the run follows
    the single-step trajectory bit for bit."""
    pw, state = _lenet()
    multi = tt.make_multi_train_step(pw.loss_fn(state.model),
                                     steps_per_call=3)
    hooks = _Hooks()
    cfg = tt.TrainerConfig(total_steps=10, log_every=4, eval_every=4,
                           eval_steps=1, checkpoint_every=4,
                           steps_per_call=3, global_batch_size=16,
                           logdir=str(tmp_path / "logs"))
    batches = [device_put_batch(b, "cpu") for b in _host_batches(pw, 10)]
    evals = lambda: iter([device_put_batch(b, "cpu")
                          for b in _host_batches(pw, 1, seed=99)])
    with tt.Trainer(multi, cfg, eval_step=tt.make_eval_step(
            pw.eval_fn(state.model)),
            checkpointer=CheckpointManager(str(tmp_path / "ck")),
            callbacks=[hooks]) as trainer:
        out = trainer.fit(state, iter(batches), eval_iter_fn=evals)
    assert out.step == 10 and hooks.steps == [3, 6, 9, 10]
    assert hooks.logs == [6, 9, 10] and hooks.evals == [6, 9]
    assert hooks.ckpts == [6, 9]
    assert sorted(CheckpointManager(str(tmp_path / "ck")).all_steps()) \
        == [6, 9, 10]

    _, ref = _lenet()
    single = tt.make_train_step(pw.loss_fn(ref.model))
    with tt.Trainer(single, tt.TrainerConfig(
            total_steps=10, log_every=0, global_batch_size=16)) as trainer:
        ref = trainer.fit(ref, iter(batches))
    for a, b in zip(out.model.parameters(), ref.model.parameters()):
        assert torch.equal(a, b)


def test_resume_at_an_unaligned_step_is_exact(tmp_path):
    """A k = 3 run stopped at step 4 (a checkpoint every 2 steps crossed
    by calls of 3: steps 3 and 4 saved) resumes from step 4 with calls of
    3, 3 and a tail of 1 to step 11, and ends on the parameters of an
    uninterrupted k = 3 run over the same batches, bit for bit."""
    pw, state = _lenet()
    batches = _host_batches(pw, 11)

    def fit(state, start, total, ckdir=None):
        multi = tt.make_multi_train_step(pw.loss_fn(state.model),
                                         steps_per_call=3)
        cfg = tt.TrainerConfig(total_steps=total, log_every=0,
                               steps_per_call=3, input_prebundled=True,
                               checkpoint_every=2 if ckdir else 0,
                               global_batch_size=16)

        def bundles():
            for i in range(start, total, 3):
                yield device_put_bundle(batches[i:min(i + 3, total)], "cpu")

        mgr = CheckpointManager(ckdir) if ckdir else None
        with tt.Trainer(multi, cfg, checkpointer=mgr) as trainer:
            return trainer.fit(state, bundles())

    whole = fit(state, 0, 11)
    ck = str(tmp_path / "ck")
    _, cut = _lenet()
    fit(cut, 0, 4, ck)
    assert sorted(CheckpointManager(ck).all_steps()) == [3, 4]
    _, resumed = _lenet()
    CheckpointManager(ck).restore_latest(resumed)
    assert resumed.step == 4
    resumed = fit(resumed, 4, 11)
    assert resumed.step == whole.step == 11
    for a, b in zip(resumed.model.parameters(), whole.model.parameters()):
        assert torch.equal(a, b)


# ------------------------------------------------------------ train_torch


@pytest.fixture
def fresh_registry():
    """A fresh default registry of the port: other tests of this worker
    process count into theirs."""
    from distributedtensorflow_tpu_torch.obs import registry

    prev = registry.set_default_registry(registry.Registry())
    yield
    registry.set_default_registry(prev)


def test_train_torch_steps_per_call_writes_valid_metrics(tmp_path,
                                                         fresh_registry):
    """``train_torch.main`` with ``--steps-per-call 3 --device cpu``
    (gpt_lm at test size, the Prefetcher's bundles): log rows at each call
    that crosses a multiple of 3 and at the last step, the multi-step
    dispatches counted, and a metrics.jsonl that
    ``tools/check_metrics_schema.py`` accepts; the losses equal a k = 1
    run's at those steps bit for bit."""
    logdir = tmp_path / "k3"
    argv = ["--workload", "gpt_lm", "--test-size", "--device", "cpu",
            "--steps", "7", "--log-every", "3"]
    records = train_torch.main(argv + ["--steps-per-call", "3",
                                       "--logdir", str(logdir)])
    assert [r["step"] for r in records] == [3, 6, 7]
    rows = _rows(logdir / "metrics.jsonl")
    assert rows[-1]["engine_dispatches_total.kind_multi_train_step"] == 3
    assert rows[-1]["data_batches_total"] == 3
    out = subprocess.run([sys.executable, "tools/check_metrics_schema.py",
                          str(logdir / "metrics.jsonl")], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    single = train_torch.main(argv + ["--log-every", "1",
                                      "--prefetch-depth", "0"])
    by_step = {r["step"]: r["loss"] for r in single}
    assert [r["loss"] for r in records] == [by_step[s] for s in (3, 6, 7)]


def test_train_torch_checks_the_new_flags():
    for flags in (["--steps-per-call", "0"], ["--prefetch-depth", "-1"]):
        with pytest.raises(SystemExit, match="must be >="):
            train_torch.main(["--workload", "gpt_lm", "--test-size",
                              "--device", "cpu", *flags])
    args = train_torch.parse_args([])
    assert args.steps_per_call == 1 and args.prefetch_depth == 2
