"""Expert parallelism of the port against the JAX package's.

``parallel.moe.make_moe_fn`` (the all-to-all region) over the ranks of a
``data=2,expert=2`` mesh of four thread ranks against JAX's
``make_moe_layer`` on ``MeshSpec(data=2, expert=2)``, for top-1, top-2
and expert choice: each replica's ranks hold its tokens, each rank its
half of the experts and routes its half of the tokens, and the output,
the aux loss and the gradients of ``sum(out * ct) + 0.7 aux`` (the
replicas' shares summed, the expert halves put together) are JAX's.
Then whole training steps from one flax init, fp32 at dropout 0, against
JAX's ``accumulate_gradients`` with the same MoE region on the same mesh
(routing depends on the mesh, so the reference is the same mesh, as
``tests/test_moe.py:125-133`` notes): ``gpt_moe`` and ``bert_moe`` at
``data=1,expert=2``, and ``gpt_moe`` at ``data=2,expert=2,model=2``
(eight thread ranks: the dense layers split over ``model`` as GPT's, the
expert stacks over ``expert`` and replicated over ``model``).  Also the
refusal of experts that the axis does not divide.

Tolerances: the region's outputs and aux 1e-6, gradients 1e-5 (as
``tests/test_torch_moe.py``); the steps' losses 1e-5 relative and
gradients 1e-4 of each leaf's max-abs, BERT's key bias left out (its
gradient is rounding noise on both sides).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtensorflow_tpu.models import bert_moe as jax_bert_moe
from distributedtensorflow_tpu.models import gpt_moe as jax_gpt_moe
from distributedtensorflow_tpu.parallel import MeshSpec as JMeshSpec
from distributedtensorflow_tpu.parallel import build_mesh as jbuild_mesh
from distributedtensorflow_tpu.parallel import moe as jmoe
from distributedtensorflow_tpu.train import engine as jax_engine
from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch import workloads as tw
from distributedtensorflow_tpu_torch.data import InputContext, device_put_batch
from distributedtensorflow_tpu_torch.models.gpt_moe import _expert_mlp
from distributedtensorflow_tpu_torch.parallel import moe as tmoe
from distributedtensorflow_tpu_torch.parallel import sharding
from distributedtensorflow_tpu_torch.parallel.mesh import MeshSpec
from distributedtensorflow_tpu_torch.testing import run_mesh
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401
from distributedtensorflow_tpu_torch.train.engine import (
    accumulate_gradients_dp,
)
from distributedtensorflow_tpu_torch.train.state import create_sharded_state

T, E, DM, FF = 48, 4, 16, 24
RTOL = 1e-5
GRAD_TOL = 1e-4


def _region_inputs(seed=5):
    rng = np.random.default_rng(seed)
    tokens = rng.standard_normal((T, DM)).astype(np.float32)
    kernel = (0.5 * rng.standard_normal((DM, E))).astype(np.float32)
    params = {"w_in": (rng.standard_normal((E, DM, FF)) / 4).astype(np.float32),
              "w_out": (rng.standard_normal((E, FF, DM)) / 5).astype(np.float32)}
    ct = rng.standard_normal((T, DM)).astype(np.float32)
    return tokens, kernel, params, ct


@pytest.mark.parametrize("router", ["top1", "top2", "expert_choice"])
def test_expert_parallel_region_matches_jax(router):
    tokens, kernel, params, ct = _region_inputs()
    cf = 1.25
    jmesh = jbuild_mesh(JMeshSpec(data=2, expert=2), jax.devices()[:4])
    layer = jmoe.make_moe_fn(jmesh, jax_gpt_moe._expert_mlp,
                             capacity_factor=cf, router=router)

    def jloss(tokens, kernel, params):
        out, aux = layer(tokens, kernel, params)
        return jnp.sum(out * ct) + 0.7 * aux, (out, aux)

    (_, (jout, jaux)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(
            jnp.asarray(tokens), jnp.asarray(kernel),
            {k: jnp.asarray(v) for k, v in params.items()})

    def body(rank, mesh):
        d, e = mesh.coords["data"], mesh.coords["expert"]
        rows = slice(d * T // 2, (d + 1) * T // 2)
        t = torch.tensor(tokens[rows]).requires_grad_()
        kern = torch.tensor(kernel).requires_grad_()
        p = {k: torch.tensor(v[e * E // 2:(e + 1) * E // 2])
             .requires_grad_() for k, v in params.items()}
        fn = tmoe.make_moe_fn(mesh, _expert_mlp, capacity_factor=cf,
                              router=router)
        out, aux = fn(t, kern, p)
        ((out * torch.tensor(ct[rows])).sum() + 0.7 * aux).backward()
        return (d, e), (out.detach(), aux.detach(), t.grad, kern.grad,
                        {k: v.grad for k, v in p.items()})

    by = dict(run_mesh(body, MeshSpec(data=2, expert=2), 4))
    for d in range(2):  # the expert ranks of a replica agree
        for a, b in zip(by[(d, 0)][:4], by[(d, 1)][:4]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    out = torch.cat([by[(d, 0)][0] for d in range(2)])
    aux = sum(by[(d, 0)][1] for d in range(2))  # the replicas' shares
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-6)
    assert (float(jaux) == 0.0) == (router == "expert_choice")
    gt = torch.cat([by[(d, 0)][2] for d in range(2)])
    gk = sum(by[(d, 0)][3] for d in range(2))
    gp = {k: torch.cat([sum(by[(d, e)][4][k] for d in range(2))
                        for e in range(2)]) for k in params}
    for name, got, ref in (("tokens", gt, jg[0]), ("router", gk, jg[1]),
                           ("w_in", gp["w_in"], jg[2]["w_in"]),
                           ("w_out", gp["w_out"], jg[2]["w_out"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-5, err_msg=name)


def test_indivisible_experts_raise():
    def body(rank, mesh):
        fn = tmoe.make_moe_fn(mesh, _expert_mlp)
        router = torch.zeros(DM, 3)  # 3 % 2 != 0
        with pytest.raises(ValueError, match="not divisible"):
            fn(torch.zeros(8, DM), router, {"w_in": torch.zeros(1, DM, FF),
                                            "w_out": torch.zeros(1, FF, DM)})
        return True

    assert run_mesh(body, MeshSpec(data=1, expert=2), 2) == [True, True]


def test_init_expert_params_keeps_each_ranks_experts():
    """Every expert drawn in order from one generator, stacked; over
    ``expert=2`` each rank keeps its half, the halves together the whole
    stack (JAX ``init_expert_params``)."""
    def init_one(gen):
        return {"w": torch.randn(3, 2, generator=gen)}

    whole = tmoe.init_expert_params(init_one, E,
                                    torch.Generator().manual_seed(0))
    assert whole["w"].shape == (E, 3, 2)

    def body(rank, mesh):
        return tmoe.init_expert_params(init_one, E,
                                       torch.Generator().manual_seed(0),
                                       mesh)["w"]

    halves = run_mesh(body, MeshSpec(data=1, expert=2), 2)
    assert torch.equal(torch.cat(halves), whole["w"])


# --------------------------------------------------------------- steps


def _flat(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), np.asarray(val)


def _gpt_moe(jmesh):
    jcfg = dataclasses.replace(jax_gpt_moe.gpt_moe_tiny(), dtype=jnp.float32)
    params = jax.device_get(jax.jit(jax_gpt_moe.GPTMoELM(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 64), jnp.int32))["params"])
    jmodel = jax_gpt_moe.GPTMoELM(jcfg, jmoe.make_moe_fn(
        jmesh, jax_gpt_moe._expert_mlp, capacity_factor=jcfg.capacity_factor,
        router=jcfg.router))
    pw = tw.get_workload("gpt_moe", test_size=True, global_batch_size=8)
    tcfg = dataclasses.replace(pw.cfg, dtype=torch.float32)
    return (jax_gpt_moe.moe_lm_loss(jmodel), params, params,
            pw, tcfg, ())


def _bert_moe(jmesh):
    jcfg = dataclasses.replace(jax_bert_moe.bert_moe_tiny(),
                               dtype=jnp.float32, dropout_rate=0.0)
    pw = tw.get_workload("bert_moe", test_size=True, global_batch_size=8)
    variables = jax.device_get(jax.jit(jax_bert_moe.BertMoEForMLM(jcfg).init)(
        jax.random.PRNGKey(1), jnp.zeros((2, pw.seq_len), jnp.int32)))
    jmodel = jax_bert_moe.BertMoEForMLM(jcfg, jmoe.make_moe_fn(
        jmesh, jax_gpt_moe._expert_mlp, capacity_factor=jcfg.capacity_factor,
        router=jcfg.router))
    p = tm.max_predictions_for(pw.seq_len)
    tcfg = dataclasses.replace(pw.cfg, dtype=torch.float32, dropout_rate=0.0)
    return (jax_bert_moe.moe_mlm_loss(jmodel, max_predictions=p),
            variables["params"], variables, pw, tcfg, ("key/bias",))


STEPS = {"gpt_moe_expert2": (_gpt_moe, dict(data=1, expert=2)),
         "bert_moe_expert2": (_bert_moe, dict(data=1, expert=2)),
         "gpt_moe_data2_expert2_model2": (_gpt_moe,
                                          dict(data=2, expert=2, model=2))}


@pytest.mark.parametrize("name", sorted(STEPS))
def test_moe_step_matches_jax(name):
    make, axes = STEPS[name]
    world = int(np.prod(list(axes.values())))
    jmesh = jbuild_mesh(JMeshSpec(**axes), jax.devices()[:world])
    jloss, params, variables, pw, tcfg, skip = make(jmesh)
    data = axes["data"]
    batches = [next(pw.input_fn(InputContext(data, r, 8), 0))
               for r in range(data)]
    glob = {k: jnp.asarray(np.concatenate([b[k] for b in batches]))
            for k in batches[0]}
    rng = jax.random.PRNGKey(0)
    jl = float(jax.jit(lambda p: jloss(p, {}, glob, rng)[0])(params))
    jgrads = dict(_flat(jax.device_get(jax.jit(
        lambda p: jax_engine.accumulate_gradients(jloss, p, {}, glob, rng,
                                                  1)[0])(params))))
    whole = tm.params_from_flax(variables, tcfg)

    def body(rank, mesh):
        wl = pw.for_mesh(mesh)
        model = wl.model_cls(tcfg, device="cpu", group=mesh)
        assert model.moe_fn is not None
        model.load_state_dict(whole)
        create_sharded_state(model, wl.make_optimizer, mesh, cfg=tcfg,
                             rules=wl.layout)
        batch = device_put_batch(batches[mesh.coords["data"]], "cpu", mesh)
        grads, metrics = accumulate_gradients_dp(
            wl.loss_fn(model, group=mesh), model, batch, mesh, seed=0,
            step=0)
        return mesh.coords, float(metrics["loss"]), grads

    outs = run_mesh(body, MeshSpec(**axes), world)
    for _, loss, _ in outs:
        np.testing.assert_allclose(loss, jl, rtol=RTOL)
    meta = pw.model_cls(tcfg, device="meta")
    rules = sharding.tp_rules(meta, tcfg, pw.layout)
    experts = sharding.ep_rules(tcfg, pw.layout)
    assert experts  # the stacks were cut
    by = {(c["data"], c["expert"], c["model"]): g for c, _, g in outs}
    n_e, n_m = axes["expert"], axes.get("model", 1)
    for d in range(data):
        per_expert = [sharding.unshard_states(
            [by[(d, e, m)] for m in range(n_m)], rules) for e in range(n_e)]
        grads = {k: torch.cat([p[k] for p in per_expert]) if k in experts
                 else per_expert[0][k] for k in per_expert[0]}
        got = tm.params_to_flax(grads, tcfg)
        got = dict(_flat(got.get("params", got)))
        assert got.keys() == jgrads.keys()
        for path, ref in jgrads.items():
            if any(s in path for s in skip):
                continue
            np.testing.assert_allclose(got[path], ref, rtol=0,
                                       atol=GRAD_TOL * np.abs(ref).max(),
                                       err_msg=path)
