"""The port's ViT and its ``imagenet_vit`` preset against the JAX package's.

Both packages run ``vit_tiny`` (32x32 images, 8x8 patches, 2 layers,
hidden 128) from one flax ``init`` moved across with
``params_from_flax``, on numpy-seeded images, in fp32 at dropout 0; on
the CPU the port's LayerNorms take the kernels' plain twins and JAX's
its XLA reference.  Tolerances: logits within 1e-5 of their max-abs,
losses 1e-5 relative, each gradient leaf within 1e-4 of its max-abs (as
``tests/test_torch_models.py``); the bf16 loss within 1e-2 relative (the
two frameworks round at other places).  The JAX package is only called.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import train_torch
from distributedtensorflow_tpu import workloads as jax_workloads
from distributedtensorflow_tpu.data.input_pipeline import (
    InputContext as JaxInputContext,
)
from distributedtensorflow_tpu.models import vit as jax_vit
from distributedtensorflow_tpu.train import losses as jax_losses
from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch import workloads as tw
from distributedtensorflow_tpu_torch.data import InputContext
from distributedtensorflow_tpu_torch.models.layers import DropoutKey
from distributedtensorflow_tpu_torch.train import classification_loss

LOGIT_TOL = 1e-5
RTOL = 1e-5
GRAD_TOL = 1e-4
BF16_RTOL = 1e-2


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


def _pair(dtype="fp32", seed=0):
    """(jax model, jax variables, port model) of vit_tiny from one init."""
    jcfg = dataclasses.replace(
        jax_vit.vit_tiny(),
        dtype={"fp32": jnp.float32, "bf16": jnp.bfloat16}[dtype])
    tcfg = dataclasses.replace(
        tm.vit_tiny(),
        dtype={"fp32": torch.float32, "bf16": torch.bfloat16}[dtype])
    jmodel = jax_vit.ViT(jcfg)
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(seed), jnp.zeros((2, 32, 32, 3))))
    model = tm.ViT(tcfg, device="cpu")
    model.load_state_dict(tm.params_from_flax(variables, tcfg))
    return jmodel, variables, model


@pytest.fixture(scope="module")
def vit():
    return _pair()


def _batch(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((n, 32, 32, 3)).astype(np.float32),
            "label": rng.integers(0, 10, n).astype(np.int32)}


def _torch(batch):
    """A numpy batch as tensors, integer arrays as int64 (the ids and
    labels ``data.device_put_batch`` gives the step)."""
    return {k: torch.as_tensor(v, dtype=torch.long if v.dtype.kind in "iu"
                               else None) for k, v in batch.items()}


def _port_loss_and_grads(model, loss_fn, batch):
    loss, metrics = loss_fn(_torch(batch))
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    return loss, metrics, dict(zip(names, grads))


def test_params_round_trip_and_names(vit):
    """``params_to_flax(params_from_flax(x)) == x`` and the state's names
    are the flax paths (``pos_embed`` and the patch conv included)."""
    _, variables, model = vit
    cfg = model.cfg
    back = tm.params_to_flax(tm.params_from_flax(variables, cfg), cfg)
    got, ref = dict(_flat(back)), dict(_flat(variables))
    assert got.keys() == ref.keys()
    for path in ref:
        np.testing.assert_array_equal(got[path], ref[path])
    assert ("params", "pos_embed") in ref
    assert tuple(model.pos_embed.shape) == (1, 16, 128)
    init = tm.init_params(cfg, torch.Generator().manual_seed(0))
    assert init.keys() == model.state_dict().keys()
    assert abs(float(init["pos_embed"].std()) - 0.02) < 2e-3


def test_logits_and_grads_match_jax(vit):
    """The forward (NHWC images, fp32) and every parameter's gradient of
    the mean cross-entropy."""
    jmodel, variables, model = vit
    batch = _batch()

    def jloss(params):
        logits = jmodel.apply({"params": params}, batch["image"])
        return jnp.mean(-jnp.take_along_axis(
            jax.nn.log_softmax(logits), batch["label"][:, None], 1)), logits

    (jl, jlogits), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    logits = model(torch.as_tensor(batch["image"]))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=0,
                               atol=LOGIT_TOL * np.abs(jlogits).max())
    loss = F.cross_entropy(logits, _torch(batch)["label"])
    np.testing.assert_allclose(loss.item(), float(jl), rtol=RTOL)
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    _assert_trees_close(tm.params_to_flax(grads, model.cfg)["params"],
                        jax.device_get(jg), GRAD_TOL)


def _jax_workload_fp32():
    """The JAX ``imagenet_vit`` preset at test size, its model at fp32."""
    jw = jax_workloads.get_workload("imagenet_vit", test_size=True,
                                    global_batch_size=8)
    jmodel = jax_vit.ViT(dataclasses.replace(jw.model.cfg,
                                             dtype=jnp.float32))
    return jw, jmodel


def test_workload_loss_and_grads_match_jax():
    """One step's loss, accuracy and gradients of the ``imagenet_vit``
    preset at test size (fp32) on its first synthetic batch, and the
    preset's settings beside JAX's."""
    jw, jmodel = _jax_workload_fp32()
    pw = tw.get_workload("imagenet_vit", test_size=True, global_batch_size=8)
    cfg = dataclasses.replace(pw.cfg, dtype=torch.float32)
    for field in ("image_size", "patch_size", "num_classes", "hidden_size",
                  "num_layers", "num_heads", "intermediate_size",
                  "dropout_rate"):
        assert getattr(cfg, field) == getattr(jw.model.cfg, field), field
    assert pw.global_batch_size == jw.global_batch_size
    assert tw.get_workload("imagenet_vit").global_batch_size == 1024
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(3), jnp.zeros((2, 32, 32, 3))))
    model = pw.model_cls(cfg, device="cpu")
    model.load_state_dict(tm.params_from_flax(variables, cfg))
    jb = next(jw.input_fn(JaxInputContext(global_batch_size=8), 0))
    tb = next(pw.input_fn(InputContext(global_batch_size=8), 0))
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])
    jloss = jax_losses.classification_loss(jmodel)
    (jl, (jm, _)), jg = jax.jit(jax.value_and_grad(
        lambda p: jloss(p, {}, jb, jax.random.PRNGKey(0)), has_aux=True))(
        variables["params"])
    loss, metrics, grads = _port_loss_and_grads(model, pw.loss_fn(model), jb)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=RTOL)
    np.testing.assert_allclose(float(metrics["accuracy"]),
                               float(jm["accuracy"]), rtol=RTOL)
    _assert_trees_close(tm.params_to_flax(grads, cfg)["params"],
                        jax.device_get(jg), GRAD_TOL)
    # the optimizer: AdamW on the warm-up cosine, and the eval's top-5
    opt = pw.make_optimizer(list(model.named_parameters()))
    assert opt.param_groups[0]["weight_decay"] == 0.05
    assert [opt.schedule(c) for c in (0, 1563, 93_750)] == pytest.approx(
        [0.0, 3e-3, 0.0])
    ev = tw.get_workload("imagenet_vit").eval_fn(model)(_torch(jb))
    assert set(ev) == {"loss", "accuracy", "top5_accuracy"}


def test_bf16_loss_matches_jax():
    """vit_tiny at the preset's bf16: the loss within 1e-2 relative (the
    frameworks round at other places; bf16 patches, pos_embed added in
    bf16, ln_f to fp32 into the fp32 head)."""
    jmodel, variables, model = _pair("bf16", seed=1)
    batch = _batch(seed=1)
    jl, _ = jax.jit(lambda p: jax_losses.classification_loss(jmodel)(
        p, {}, batch, jax.random.PRNGKey(0)))(variables["params"])
    loss, _ = classification_loss(model)(_torch(batch))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=BF16_RTOL)


def test_dropout_draws_from_the_step_key_and_checks_input():
    """With a dropout rate the training forward draws one seed a block
    from the step's ``DropoutKey`` (the same key, the same logits; another
    key, others); eval and rate 0 are the identity; a non-NHWC input
    raises, as JAX's ``ViT`` does."""
    cfg = dataclasses.replace(tm.vit_tiny(), dtype=torch.float32,
                              dropout_rate=0.1)
    model = tm.ViT(cfg, device="cpu")
    model.load_state_dict(tm.init_params(cfg,
                                         torch.Generator().manual_seed(0)))
    x = torch.as_tensor(_batch()["image"])
    a = model(x, train=True, generator=DropoutKey(5))
    b = model(x, train=True, generator=DropoutKey(5))
    c = model(x, train=True, generator=DropoutKey(6))
    key = DropoutKey(7)
    model(x, train=True, generator=key)
    assert key.sites == cfg.num_layers
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(model(x), model(x, train=False))
    with pytest.raises(ValueError, match="NHWC"):
        model(x.permute(0, 3, 1, 2))


def test_train_torch_runs_imagenet_vit(capsys):
    """``train_torch.py --workload imagenet_vit --test-size`` on the CPU:
    twelve steps of the preset (AdamW on its warm-up from 0) with an eval,
    the last steps' losses below the first ones'."""
    records = train_torch.main(
        ["--workload", "imagenet_vit", "--test-size", "--device", "cpu",
         "--steps", "12", "--log-every", "1", "--batch-size", "32",
         "--eval-every", "12"])
    losses = [r["loss"] for r in records]
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert set(records[0]) == {"step", "loss", "step_ms", "examples_per_sec"}
    assert len(capsys.readouterr().out.strip().splitlines()) == 12

