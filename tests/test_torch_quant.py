"""The port's quantised matmuls and loss scaling against the JAX package.

``ops/quant.py`` of both packages on the same numpy inputs: the int8
codes and scales of ``quantize``, the fp8 casts, ``int8_dot``'s int32
accumulator, ``quantized_matmul`` and its straight-through gradients,
the four loss-scale functions, and a ``gpt_tiny`` training step at
``quant="int8"`` and ``"fp8"`` from converted weights against JAX's
``GPTConfig.quant`` step.  ``int8_stochastic`` draws from the port's
Philox, not from ``jax.random``: it is held to unbiasedness, not to
JAX's codes.

Tolerances: codes, scales, fp8 values and the int32 accumulator exactly;
the rescaled int8 product exactly (the same fp32 operations); an fp8
product 1e-6 of its max (fp32 sums in another order); straight-through
gradients 1e-6 of their max (fp32 products); the loss-scale trajectory
exactly; the gpt_tiny step's loss 1e-5 relative and its gradients 2e-3
of each leaf's max (a code can round the other way where an input to a
quantiser differs by an ulp, and that flips one grid step of 1/127 of
its channel's absmax).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtensorflow_tpu.models import GPTLM as JaxGPTLM
from distributedtensorflow_tpu.models import gpt_tiny as jax_gpt_tiny
from distributedtensorflow_tpu.models import lm_loss as jax_lm_loss
from distributedtensorflow_tpu.ops import quant as jq
from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch.ops import quant as tq
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401


def _rand(shape, seed, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[0] = 0.0  # a zero channel takes the scale 1/qmax
    return x * scale


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantize_codes_and_scales_equal_jax(mode):
    """Rows of x over the contraction (last) axis and columns of w over
    axis 0: the port's (N, K) weight quantised over its last dim is JAX's
    (K, N) over axis 0, transposed."""
    x, w = _rand((9, 48), 0, 3.0), _rand((48, 16), 1)
    jqx, jsx = jq.quantize(jnp.asarray(x), axis=-1, mode=mode)
    jqw, jsw = jq.quantize(jnp.asarray(w), axis=0, mode=mode)
    qx, sx = tq.quantize(torch.from_numpy(x), dim=-1, mode=mode)
    qw, sw = tq.quantize(torch.from_numpy(w.T.copy()), dim=-1, mode=mode)
    np.testing.assert_array_equal(qx.float().numpy(),
                                  np.asarray(jqx, np.float32))
    np.testing.assert_array_equal(qw.float().numpy().T,
                                  np.asarray(jqw, np.float32))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    np.testing.assert_array_equal(sw.numpy().T, np.asarray(jsw))
    assert qx.dtype == (torch.int8 if mode == "int8" else tq.FP8)


def test_int8_accumulator_and_product_equal_jax():
    """The int32 accumulator of the codes equals JAX's
    ``dot_general(preferred_element_type=int32)``; the rescaled product
    ``acc * sx * sw`` equals ``int8_dot``'s bit for bit."""
    x, w = _rand((2, 7, 64), 2, 2.0), _rand((64, 24), 3)
    jqx, _ = jq.quantize(jnp.asarray(x), axis=-1)
    jqw, _ = jq.quantize(jnp.asarray(w), axis=0)
    jacc = jax.lax.dot_general(jqx, jqw, (((2,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    qx, _ = tq.quantize(torch.from_numpy(x).reshape(-1, 64), dim=-1)
    qw, _ = tq.quantize(torch.from_numpy(w.T.copy()), dim=-1)
    acc = tq.narrow_product(qx, qw)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy().reshape(2, 7, 24),
                                  np.asarray(jacc))
    got = tq.int8_dot(torch.from_numpy(x), torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jq.int8_dot(jnp.asarray(x),
                                                         jnp.asarray(w))))


def test_fp8_product_close_to_jax():
    x, w = _rand((12, 32), 4, 5.0), _rand((32, 16), 5)
    ref = np.asarray(jq.int8_dot(jnp.asarray(x), jnp.asarray(w), mode="fp8"))
    got = tq.int8_dot(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                      mode="fp8").numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("mode", ["none", "int8", "fp8"])
def test_quantized_matmul_and_straight_through_grads_match_jax(mode):
    x, w = _rand((3, 5, 32), 6), _rand((32, 16), 7)
    g = _rand((3, 5, 16), 8)
    jy, vjp = jax.vjp(lambda a, b: jq.quantized_matmul(a, b, mode=mode),
                      jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w.T.copy()).requires_grad_()
    y = tq.quantized_matmul(tx, tw, mode=mode)
    y.backward(torch.from_numpy(g))
    fwd_tol = 0 if mode == "int8" else 1e-6
    for got, ref, tol in ((y.detach().numpy(), jy, fwd_tol),
                          (tx.grad.numpy(), jdx, 1e-6),
                          (tw.grad.numpy().T, jdw, 1e-6)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=tol * np.abs(ref).max() + 1e-30)


def test_loss_scale_functions_match_jax():
    """scale_loss, unscale_grads, grads_finite and a loss_scale_update
    trajectory (growth every 2 finite steps, halving on an overflow,
    clamped at 1) equal JAX's."""
    jstate, tstate = jq.DynamicLossScale.init(4.0), tq.DynamicLossScale.init(
        4.0)
    loss = np.float32(1.5)
    assert float(tq.scale_loss(torch.tensor(loss), tstate)) == \
        float(jq.scale_loss(jnp.asarray(loss), jstate))
    grads = [_rand((4, 3), 9), _rand((5,), 10)]
    jun = jq.unscale_grads([jnp.asarray(g) for g in grads], jstate)
    tun = tq.unscale_grads([torch.from_numpy(g) for g in grads], tstate)
    for a, b in zip(tun, jun):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    bad = [torch.from_numpy(grads[0]), torch.tensor([1.0, float("inf")])]
    assert bool(tq.grads_finite(bad)) == bool(jq.grads_finite(
        [jnp.asarray(b.numpy()) for b in bad])) is False
    assert bool(tq.grads_finite([torch.from_numpy(g) for g in grads]))
    for finite in (True, True, False, True, True, True, False, False, False):
        jstate = jq.loss_scale_update(jstate, jnp.asarray(finite),
                                      growth_interval=2)
        tstate = tq.loss_scale_update(tstate, torch.tensor(finite),
                                      growth_interval=2)
        assert float(tstate.scale) == float(jstate.scale)
        assert int(tstate.good_steps) == int(jstate.good_steps)


def test_int8_stochastic_is_unbiased():
    """The mean of the stochastic codes over 512 seeds is x within 4
    standard errors of the per-element rounding noise (at most s/2 a
    draw); the same (seed, site) draws the same codes, another site
    others."""
    x = torch.from_numpy(_rand((16, 64), 11))
    _, scale = tq.quantize(x, mode="int8")
    draws = torch.stack([tq.dequantize(*tq.quantize(
        x, mode="int8_stochastic", key=(seed, 3))) for seed in range(512)])
    err = (draws.mean(0) - x).abs()
    assert float((err / scale).max()) < 4 * 0.5 / np.sqrt(512)
    q1, _ = tq.quantize(x, mode="int8_stochastic", key=(7, 3))
    q2, _ = tq.quantize(x, mode="int8_stochastic", key=(7, 3))
    q3, _ = tq.quantize(x, mode="int8_stochastic", key=(7, 4))
    assert torch.equal(q1, q2) and not torch.equal(q1, q3)


def _gpt_step(mode, ids):
    jcfg = dataclasses.replace(jax_gpt_tiny(), dtype=jnp.float32, quant=mode)
    tcfg = dataclasses.replace(tm.gpt_tiny(), dtype=torch.float32, quant=mode)
    params = jax.jit(JaxGPTLM(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((2, ids.shape[1]),
                                         jnp.int32))["params"]
    loss_fn = jax_lm_loss(JaxGPTLM(jcfg))

    def jloss(p):
        return loss_fn(p, {}, {"input_ids": jnp.asarray(ids)},
                       jax.random.PRNGKey(1))[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    model = tm.GPTLM(tcfg, device="cpu")
    model.load_state_dict(tm.params_from_flax(params, tcfg))
    loss, _ = tm.lm_loss(model)({"input_ids": torch.from_numpy(ids)}, None)
    loss.backward()
    grads = tm.params_to_flax({n: p.grad for n, p in
                               model.named_parameters()}, tcfg)
    return (float(loss.detach()), float(jl), grads, jax.device_get(jg),
            params)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_gpt_tiny_quantised_step_matches_jax(mode):
    """gpt_tiny in fp32 at ``quant=mode`` from converted weights: the
    loss and every gradient against JAX's ``GPTConfig.quant`` step on the
    same batch, and the loss moved off the full-width one (the
    quantised path ran)."""
    ids = np.random.default_rng(12).integers(0, 512, (2, 32)).astype(
        np.int32)
    loss, jloss, grads, jgrads, params = _gpt_step(mode, ids)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    got = dict(_leaves(grads))
    for name, ref in _leaves(jgrads):
        np.testing.assert_allclose(got[name], ref, rtol=0,
                                   atol=2e-3 * np.abs(ref).max(),
                                   err_msg=name)
    tcfg = dataclasses.replace(tm.gpt_tiny(), dtype=torch.float32)
    model = tm.GPTLM(tcfg, device="cpu")
    model.load_state_dict(tm.params_from_flax(params, tcfg))
    with torch.no_grad():
        full = float(tm.lm_loss(model)({"input_ids": torch.from_numpy(ids)},
                                       None)[0])
    assert loss != full
