"""The port's BASELINE.json presets against the JAX package's: sources,
losses, optimizers, presets, gradient accumulation with BatchNorm and
whole training steps.

Both packages start from one flax ``init`` moved across with
``params_from_flax`` and read batches from their own copies of the
numpy sources (held equal here batch for batch).  fp32 at dropout 0;
tolerances: 1e-5 relative for losses, metrics and running statistics,
1e-4 of a leaf's max-abs for gradients.  The JAX package is only called.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import train_torch
from distributedtensorflow_tpu import workloads as jax_workloads
from distributedtensorflow_tpu.data import input_pipeline as jax_input
from distributedtensorflow_tpu.models import lenet as jax_lenet
from distributedtensorflow_tpu.models import resnet as jax_resnet
from distributedtensorflow_tpu.train import engine as jax_engine
from distributedtensorflow_tpu.train import losses as jax_losses
from distributedtensorflow_tpu.train.state import TrainState as JaxTrainState
from distributedtensorflow_tpu_torch import data as td
from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch import train as tt
from distributedtensorflow_tpu_torch import workloads as tw
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401

RTOL = 1e-5
GRAD_TOL = 1e-4


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


def _torch_batch(batch):
    return {k: torch.as_tensor(v, dtype=torch.long if v.dtype.kind in "iu"
                               else None) for k, v in batch.items()}


def _jax_ctx(n, pid=0):
    return jax_input.InputContext(global_batch_size=n, input_pipeline_id=pid)


def _ctx(n, pid=0):
    return td.InputContext(global_batch_size=n, input_pipeline_id=pid)


# ----------------------------------------------------------------- sources


def _examples(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        n = int(rng.integers(0, 15))  # 0-length examples are skipped
        ids = rng.integers(4, 50, n)
        yield {"input_ids": ids, "labels": np.where(ids % 3 == 0, ids, -100),
               "weights": ids % 2}


SOURCES = {
    "synthetic_classification": (
        lambda: jax_input.synthetic_classification(
            _jax_ctx(6, 1), image_shape=(8, 8, 3), num_classes=10, seed=2),
        lambda: td.synthetic_classification(
            _ctx(6, 1), image_shape=(8, 8, 3), num_classes=10, seed=2)),
    "pack_sequences": (
        lambda: jax_input.pack_sequences(
            _examples(0), 24, pad_value=1, extra_keys=("labels", "weights"),
            fill_values={"weights": 0}),
        lambda: td.pack_sequences(
            _examples(0), 24, pad_value=1, extra_keys=("labels", "weights"),
            fill_values={"weights": 0})),
    "synthetic_mlm": (
        lambda: jax_workloads.synthetic_mlm(_jax_ctx(4, 1), vocab_size=97,
                                            seq_len=16, seed=3),
        lambda: tw.synthetic_mlm(_ctx(4, 1), vocab_size=97, seq_len=16,
                                 seed=3)),
    "synthetic_packed_mlm": (
        lambda: jax_workloads.synthetic_packed_mlm(
            _jax_ctx(4, 1), vocab_size=97, seq_len=32, seed=3),
        lambda: tw.synthetic_packed_mlm(_ctx(4, 1), vocab_size=97,
                                        seq_len=32, seed=3)),
    "synthetic_recsys": (
        lambda: jax_workloads.synthetic_recsys(
            _jax_ctx(8, 1), jax_workloads.WideDeepConfig(), 5),
        lambda: tw.synthetic_recsys(_ctx(8, 1), tw.WideDeepConfig(), 5)),
}


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_sources_match_jax(name):
    """Each of the first batches (rows, for the packer) equal, keys,
    values and dtypes."""
    jit_, tit = (make() for make in SOURCES[name])
    for _ in range(4):
        a, b = next(jit_), next(tit)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_pack_sequences_layout():
    """Whole examples in arrival order, 1-based segments, positions that
    restart, -100 label padding; an over-long example is truncated."""
    rows = list(td.pack_sequences(
        [{"input_ids": [5, 6, 7], "labels": [1, 2, 3]},
         {"input_ids": [8, 9], "labels": [4, 5]},
         {"input_ids": list(range(10, 20)), "labels": list(range(10))}],
        6, extra_keys=("labels",)))
    assert [r["input_ids"].tolist() for r in rows] == [
        [5, 6, 7, 8, 9, 0], [10, 11, 12, 13, 14, 15]]
    assert rows[0]["segment_ids"].tolist() == [1, 1, 1, 2, 2, 0]
    assert rows[0]["position_ids"].tolist() == [0, 1, 2, 0, 1, 0]
    assert rows[0]["labels"].tolist() == [1, 2, 3, 4, 5, -100]


# ------------------------------------------------------------------ losses


@pytest.fixture(scope="module")
def lenet():
    model = jax_lenet.LeNet5()
    variables = jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(4), jnp.zeros((2, 28, 28, 1))))
    rng = np.random.default_rng(6)
    batch = {"image": rng.standard_normal((8, 28, 28, 1)).astype(np.float32),
             "label": rng.integers(0, 10, 8).astype(np.int32)}
    return model, variables, batch


def test_classification_loss_with_l2_matches_jax(lenet):
    """The cross-entropy plus ``0.5 * wd * sum(p**2)`` over the kernels
    (rank > 1, biases left out), the accuracy and every gradient."""
    jmodel, variables, batch = lenet
    wd = 1e-2
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, (jm, _)), jgrads = jax.value_and_grad(
        lambda p: jax_losses.classification_loss(jmodel, weight_decay=wd)(
            p, {}, jbatch, None), has_aux=True)(
        jax.tree.map(jnp.asarray, variables["params"]))
    model = tm.LeNet5(device="cpu")
    model.load_state_dict(tm.params_from_flax(variables, tm.LeNetConfig()))
    loss, m = tt.classification_loss(model, weight_decay=wd)(
        _torch_batch(batch))
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    plain, _ = tt.classification_loss(model)(_torch_batch(batch))
    l2 = sum(float(p.detach().square().sum()) for p in params
             if p.dim() > 1)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(float(loss - plain), 0.5 * wd * l2, rtol=1e-4)
    np.testing.assert_allclose(float(m["accuracy"]), float(jm["accuracy"]))
    _assert_trees_close(
        tm.params_to_flax(dict(zip(names, grads)), tm.LeNetConfig()),
        {"params": jax.device_get(jgrads)}, GRAD_TOL)


def test_classification_eval_matches_jax(lenet):
    """Loss, top-1 and top-5 accuracy, and no autograd graph."""
    jmodel, variables, batch = lenet
    ref = jax_losses.classification_eval(jmodel, top5=True)(
        jax.tree.map(jnp.asarray, variables["params"]), {},
        {k: jnp.asarray(v) for k, v in batch.items()})
    model = tm.LeNet5(device="cpu")
    model.load_state_dict(tm.params_from_flax(variables, tm.LeNetConfig()))
    got = tt.classification_eval(model, top5=True)(_torch_batch(batch))
    assert got.keys() == ref.keys()
    for k in got:
        assert not got[k].requires_grad
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=RTOL)


# --------------------------------------------------- accumulation with BN


@pytest.fixture(scope="module")
def resnet20():
    jmodel = jax_resnet.ResNet20(dtype=jnp.float32)
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(5), jnp.zeros((2, 32, 32, 3))))
    rng = np.random.default_rng(7)
    # random BN scales and running statistics: the zero-init scales would
    # hide the blocks' residual branches from the gradients
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                      if p[-1].key in ("scale", "var") else v), variables)
    return jmodel, variables


def test_accumulate_gradients_with_batch_norm_matches_jax_scan(resnet20):
    """ResNet-20 with the loss-side L2 at ``accum_steps=2``: gradients and
    metrics averaged over the microbatches, and the running statistics
    updated once per microbatch in order, as the JAX scan threads
    ``model_state``."""
    jmodel, variables = resnet20
    rng = np.random.default_rng(8)
    batch = {"image": rng.standard_normal((8, 32, 32, 3)).astype(np.float32),
             "label": rng.integers(0, 10, 8).astype(np.int32)}
    jloss = jax_losses.classification_loss(jmodel, weight_decay=1e-4)
    grads, metrics, mstate = jax.jit(
        lambda p, ms, b: jax_engine.accumulate_gradients(
            jloss, p, ms, b, jax.random.PRNGKey(0), 2))(
        jax.tree.map(jnp.asarray, variables["params"]),
        {"batch_stats": jax.tree.map(jnp.asarray, variables["batch_stats"])},
        {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = tm.CifarResNetConfig(dtype=torch.float32)
    model = tm.CifarResNet(cfg, device="cpu")
    model.load_state_dict(tm.params_from_flax(variables, cfg))
    tgrads, tmetrics = tt.accumulate_gradients(
        tt.classification_loss(model, weight_decay=1e-4), model,
        _torch_batch(batch), seed=0, step=0, accum_steps=2)
    assert tmetrics.keys() == metrics.keys()
    for k in metrics:
        np.testing.assert_allclose(float(tmetrics[k]), float(metrics[k]),
                                   rtol=RTOL, err_msg=k)
    _assert_trees_close(tm.params_to_flax(tgrads, cfg),
                        {"params": jax.device_get(grads)}, GRAD_TOL)
    stats = tm.params_to_flax(model.state_dict(), cfg)["batch_stats"]
    _assert_trees_close(stats, jax.device_get(mstate["batch_stats"]), RTOL)


# -------------------------------------------------------------- optimizers


def test_sgd_schedule_and_adagrad_match_optax():
    """The presets' optimizers update for update on one gradient
    sequence: sgd with momentum (LeNet), nesterov sgd on ResNet-50's
    warmup-cosine schedule (scaled to a few steps) and adagrad."""
    sched = optax.warmup_cosine_decay_schedule(0.0, 0.8, 1563, 112_590)
    port_sched = tt.warmup_cosine_decay_schedule(0.0, 0.8, 1563, 112_590)
    for count in (0, 1, 700, 1563, 1564, 50_000, 112_590, 200_000):
        # optax forms 0.8 - 0.8 * (1 - count / 1563) in fp32; its rounding
        # (~6e-8 near the peak) is what the early warmup values share
        np.testing.assert_allclose(port_sched(count), float(sched(count)),
                                   rtol=1e-6, atol=1e-7)
    short = (optax.warmup_cosine_decay_schedule(0.0, 0.5, 2, 6),
             tt.warmup_cosine_decay_schedule(0.0, 0.5, 2, 6))
    cases = [
        (optax.sgd(0.05, momentum=0.9),
         lambda p: tt.sgd(p, 0.05, momentum=0.9)),
        (optax.sgd(short[0], momentum=0.9, nesterov=True),
         lambda p: tt.sgd(p, short[1], momentum=0.9, nesterov=True)),
        (optax.adagrad(0.01), lambda p: tt.adagrad(p, 0.01)),
    ]
    rng = np.random.default_rng(9)
    w0 = rng.standard_normal((5, 3)).astype(np.float32)
    gs = [rng.standard_normal((5, 3)).astype(np.float32) for _ in range(6)]
    for tx, make in cases:
        params = jnp.asarray(w0)
        opt_state = tx.init(params)
        p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
        opt = make([p])
        for g in gs:
            updates, opt_state = tx.update(jnp.asarray(g), opt_state, params)
            params = optax.apply_updates(params, updates)
            p.grad = torch.from_numpy(g)
            opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params),
                                   rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------- presets


PRESETS = ("mnist_lenet", "cifar_resnet20", "imagenet_resnet50", "bert_mlm",
           "bert_mlm_packed", "widedeep")


@pytest.mark.parametrize("test_size", [False, True])
@pytest.mark.parametrize("name", PRESETS)
def test_get_workload_matches_jax(name, test_size):
    """The JAX defaults: global batch, accumulation, sequence length, the
    model's config, and the first batch of the input (at batch 4)."""
    jw = jax_workloads.get_workload(name, test_size=test_size)
    pw = tw.get_workload(name, test_size=test_size)
    assert pw.global_batch_size == jw.global_batch_size
    assert pw.accum_steps == jw.accum_steps
    jm = jw.model
    if name.startswith("bert"):
        assert pw.seq_len == jw.init_batch["input_ids"].shape[1]
        for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                  "intermediate_size", "max_position", "dropout_rate"):
            assert getattr(pw.cfg, f) == getattr(jm.cfg, f), f
    elif name == "widedeep":
        for f in ("vocab_sizes", "embed_dim", "num_dense_features",
                  "mlp_dims"):
            assert tuple(np.atleast_1d(getattr(pw.cfg, f))) \
                == tuple(np.atleast_1d(getattr(jm.cfg, f))), f
    else:
        assert pw.seq_len is None
        assert str(pw.cfg.dtype).removeprefix("torch.") \
            == jnp.dtype(jm.dtype).name
        assert pw.cfg.num_classes == jm.num_classes
        if name == "imagenet_resnet50":
            assert pw.cfg.stage_sizes == tuple(jm.stage_sizes)
    jb = next(jw.input_fn(_jax_ctx(4), 0))
    pb = next(pw.input_fn(_ctx(4), 0))
    assert jb.keys() == pb.keys()
    for k in jb:
        np.testing.assert_array_equal(jb[k], pb[k], err_msg=k)
        assert k not in jw.init_batch \
            or jb[k].shape[1:] == jw.init_batch[k].shape[1:]


@pytest.mark.parametrize("name", PRESETS)
def test_train_torch_runs_each_preset(name, capsys):
    """``train_torch.py --workload <preset> --test-size --device cpu``,
    cut to batch 8 and two steps: finite losses and the preset's rates
    in each printed line."""
    records = train_torch.main(["--workload", name, "--test-size",
                                "--device", "cpu", "--steps", "2",
                                "--log-every", "1", "--batch-size", "8"])
    assert [r["step"] for r in records] == [1, 2]
    rates = {"examples_per_sec"} | (
        {"tokens_per_sec"} if name.startswith("bert") else set())
    for r in records:
        assert np.isfinite(r["loss"]) and r["step_ms"] > 0
        assert set(r) == {"step", "loss", "step_ms"} | rates
    assert len(capsys.readouterr().out.strip().splitlines()) == 2


def test_batches_keep_their_dtype():
    """Ids and labels reach the model as ``torch.long``; images and dense
    features stay fp32."""
    out = next(train_torch._device_batches(
        iter([{"image": np.zeros((2, 4, 4, 3), np.float32),
               "label": np.zeros(2, np.int32),
               "dense": np.ones((2, 3), np.float32)}]), "cpu"))
    assert out["image"].dtype == out["dense"].dtype == torch.float32
    assert out["label"].dtype == torch.long


#: preset -> (dtype override for fp32, steps).  BERT's four microbatches
#: and dropout draw other bits in each package, so it is held to the
#: models' tests (tests/test_torch_models.py) instead.
STEP_PRESETS = {"mnist_lenet": 3, "cifar_resnet20": 3, "widedeep": 3}


@pytest.mark.parametrize("name", sorted(STEP_PRESETS))
def test_train_steps_match_jax(name):
    """Three steps of the preset at test size (fp32, batch 8) through the
    port's ``make_train_step`` and the JAX ``_step_body``, from one init,
    on the same batches: the losses and the metrics of each step agree
    within 1e-5; after the last, the running statistics within 1e-4 of a
    leaf's max-abs and the parameters within 1e-3 (they carry three
    updates' gradient rounding).  ResNet-20's parameters are left out:
    at its second step JAX's gradient of one BatchNorm channel
    (``ResidualBlock_1/BatchNorm_0/bias[10]``) lies 6% from an fp64
    evaluation of the same weights, the port's within 1e-5 of it."""
    jw = jax_workloads.get_workload(name, test_size=True,
                                    global_batch_size=8)
    pw = tw.get_workload(name, test_size=True, global_batch_size=8)
    jmodel, cfg = jw.model, pw.cfg
    if name == "widedeep":
        jmodel = jax_workloads.WideDeep(dataclasses.replace(
            jmodel.cfg, dtype=jnp.float32))
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
        jloss = jax_workloads.widedeep_loss(jmodel)
    else:
        jloss = jw.loss_fn
    variables = jax.device_get(jw.init_fn(jax.random.PRNGKey(6)))
    tx = jw.make_optimizer()
    params = jax.tree.map(jnp.asarray, variables["params"])
    mstate = {k: v for k, v in variables.items() if k != "params"}
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           model_state=jax.tree.map(jnp.asarray, mstate),
                           opt_state=tx.init(params), tx=tx)
    jstep = jax.jit(jax_engine._step_body(jloss, 1))
    model = pw.model_cls(cfg, device="cpu")
    model.load_state_dict(tm.params_from_flax(variables, cfg))
    state = tt.TrainState(0, model,
                          pw.make_optimizer(list(model.named_parameters())))
    step = tt.make_train_step(pw.loss_fn(model))
    jsrc, tsrc = jw.input_fn(_jax_ctx(8), 0), pw.input_fn(_ctx(8), 0)
    for _ in range(STEP_PRESETS[name]):
        jb = next(jsrc)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in jb.items()},
                           jax.random.PRNGKey(0))
        state, m = step(state, _torch_batch(next(tsrc)))
        assert m.keys() == jm.keys()
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=RTOL,
                                       atol=1e-7, err_msg=k)
    got = tm.params_to_flax(model.state_dict(), cfg)
    ref = jax.device_get({"params": jstate.params, **jstate.model_state})
    if name != "cifar_resnet20":
        _assert_trees_close(got["params"], ref["params"], 1e-3)
    if "batch_stats" in ref:
        _assert_trees_close(got["batch_stats"], ref["batch_stats"], GRAD_TOL)
