"""The port's single-device MoE (routers, ``local_moe``) against JAX's.

The JAX side is ``distributedtensorflow_tpu/parallel/moe.py``, called on
the CPU; the port keeps each assignment as (expert, slot, kept, gate)
indices, which the tests turn back into JAX's one-hot (T, E, C) dispatch
and combine tensors to compare.  Inputs come from numpy with fixed seeds,
fp32.  Dispatch is exact (the same queue positions and slots); combine
and the outputs agree to atol 1e-6 (a token's two gated expert outputs
are summed as two rounded products here and inside an fp32 matmul in
JAX); gradients to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtensorflow_tpu.models.gpt_moe import (
    _expert_mlp as jax_expert_mlp,
)
from distributedtensorflow_tpu.parallel import moe as jmoe
from distributedtensorflow_tpu_torch.models.gpt_moe import _expert_mlp
from distributedtensorflow_tpu_torch.parallel import moe as tmoe
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401

T, E, DM, FF = 48, 4, 16, 24

#: router, capacity factor, token mask.  0.5 forces drops: first choices
#: overflow some experts and second choices queue behind every first
#: choice (GShard's priority rule, ``parallel/moe.py:110-114``).
CASES = {
    "top1": ("top1", 1.25, False),
    "top2": ("top2", 1.25, False),
    "top1_drops": ("top1", 0.5, False),
    "top2_drops": ("top2", 0.5, False),
    "top1_token_mask": ("top1", 1.25, True),
    "top2_token_mask": ("top2", 1.25, True),
    "top2_drops_token_mask": ("top2", 0.5, True),
}


def _case(name, seed):
    router, cf, masked = CASES[name]
    rng = np.random.default_rng(seed)
    tokens = rng.standard_normal((T, DM)).astype(np.float32)
    kernel = (0.5 * rng.standard_normal((DM, E))).astype(np.float32)
    params = {"w_in": (rng.standard_normal((E, DM, FF)) / 4).astype(np.float32),
              "w_out": (rng.standard_normal((E, FF, DM)) / 5).astype(np.float32)}
    tmask = (rng.random(T) > 0.25).astype(np.float32) if masked else None
    return router, cf, tokens, kernel, params, tmask


def _one_hot(expert, slot, keep, gate, capacity):
    """The port's assignments as JAX's (T, E, C) dispatch and combine."""
    expert, slot, keep = (x.numpy() for x in (expert, slot, keep))
    gate = gate.detach().numpy()
    dispatch = np.zeros((T, E, capacity), np.float32)
    combine = np.zeros((T, E, capacity), np.float32)
    t, a = np.nonzero(keep)
    np.add.at(dispatch, (t, expert[t, a], slot[t, a]), 1.0)
    np.add.at(combine, (t, expert[t, a], slot[t, a]), gate[t, a])
    return dispatch, combine


@pytest.mark.parametrize("case", sorted(CASES))
def test_routers_match_jax(case):
    router, cf, tokens, kernel, _, tmask = _case(case, seed=1)
    logits = tokens @ kernel
    capacity = tmoe.capacity_for(T, E, cf, router)
    jd, jc, jaux = jmoe.ROUTERS[router](
        jnp.asarray(logits), capacity,
        None if tmask is None else jnp.asarray(tmask))
    expert, slot, keep, gate, aux = tmoe.ROUTERS[router](
        torch.from_numpy(logits), capacity,
        None if tmask is None else torch.from_numpy(tmask))
    assert expert.shape == (T, tmoe._ASSIGNMENTS[router])
    dispatch, combine = _one_hot(expert, slot, keep, gate, capacity)
    np.testing.assert_array_equal(dispatch, np.asarray(jd))
    np.testing.assert_allclose(combine, np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-6)
    if cf < 1:  # the case drops assignments, as intended
        assert int(keep.sum()) < keep.numel()
    if tmask is not None:  # pads take no slot
        assert not keep[torch.from_numpy(tmask) == 0].any()


def _jax_moe(router, cf, tokens, kernel, params, tmask):
    def f(tokens, kernel, params):
        return jmoe.local_moe(tokens, kernel, params, jax_expert_mlp,
                              capacity_factor=cf, router=router,
                              token_mask=None if tmask is None
                              else jnp.asarray(tmask))

    return f


def _port_moe(router, cf, tmask):
    def f(tokens, kernel, params):
        return tmoe.local_moe(tokens, kernel, params, _expert_mlp,
                              capacity_factor=cf, router=router,
                              token_mask=None if tmask is None
                              else torch.from_numpy(tmask))

    return f


@pytest.mark.parametrize("case", sorted(CASES))
def test_local_moe_matches_jax(case):
    router, cf, tokens, kernel, params, tmask = _case(case, seed=2)
    jout, jaux = jax.jit(_jax_moe(router, cf, tokens, kernel, params, tmask))(
        jnp.asarray(tokens), jnp.asarray(kernel),
        {k: jnp.asarray(v) for k, v in params.items()})
    out, aux = _port_moe(router, cf, tmask)(
        torch.from_numpy(tokens), torch.from_numpy(kernel),
        {k: torch.from_numpy(v) for k, v in params.items()})
    assert out.dtype == torch.float32 and out.shape == (T, DM)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_local_moe_grads_match_jax(case):
    """Gradients of ``sum(out * ct) + 0.7 * aux`` with respect to the
    tokens, the router kernel and the experts."""
    router, cf, tokens, kernel, params, tmask = _case(case, seed=3)
    ct = np.random.default_rng(4).standard_normal((T, DM)).astype(np.float32)
    jf = _jax_moe(router, cf, tokens, kernel, params, tmask)

    def jloss(tokens, kernel, params):
        out, aux = jf(tokens, kernel, params)
        return jnp.sum(out * ct) + 0.7 * aux

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(tokens), jnp.asarray(kernel),
        {k: jnp.asarray(v) for k, v in params.items()})
    t = torch.from_numpy(tokens).requires_grad_(True)
    kern = torch.from_numpy(kernel).requires_grad_(True)
    p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    out, aux = _port_moe(router, cf, tmask)(t, kern, p)
    ((out * torch.from_numpy(ct)).sum() + 0.7 * aux).backward()
    for name, got, ref in (("tokens", t.grad, jg[0]), ("router", kern.grad,
                                                       jg[1]),
                           ("w_in", p["w_in"].grad, jg[2]["w_in"]),
                           ("w_out", p["w_out"].grad, jg[2]["w_out"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-5, err_msg=name)


def test_bf16_tokens_keep_their_dtype_and_unknown_routers_raise():
    """bf16 tokens go through the experts in bf16 and come back in bf16
    (the copies into the slots are exact), under top-2 and expert choice;
    a router neither package has raises."""
    _, cf, tokens, kernel, params, _ = _case("top2", seed=5)
    tb = torch.from_numpy(tokens).to(torch.bfloat16)
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    for router in ("top2", "expert_choice"):
        out, _ = tmoe.local_moe(tb, torch.from_numpy(kernel), p, _expert_mlp,
                                capacity_factor=cf, router=router)
        assert out.dtype == torch.bfloat16
        ref, _ = tmoe.local_moe(
            tb.float(), torch.from_numpy(kernel), p,
            lambda q, x: _expert_mlp(q, x.bfloat16()).float(),
            capacity_factor=cf, router=router)
        assert torch.equal(out, ref.to(torch.bfloat16))
    with pytest.raises(ValueError, match="unknown router"):
        tmoe.local_moe(tb, torch.from_numpy(kernel), p, _expert_mlp,
                       router="hash")


@pytest.mark.parametrize("tokens,cf,router,want", [
    (16384, 1.25, "top2", 5120), (16384, 1.25, "top1", 2560),
    (1024, 1.25, "top2", 320), (3, 0.5, "top2", 1),
    (32768, 1.25, "expert_choice", 5120)])
def test_capacity_is_jaxs(tokens, cf, router, want):
    """``max(1, int(T * cf * assignments / E))`` with E 8, as
    ``local_moe`` sizes it (``parallel/moe.py:367``)."""
    assert tmoe.capacity_for(tokens, 8, cf, router) == want
