"""Clipping by the global norm over split parameters, against JAX's step.

``optax.clip_by_global_norm`` reads the norm of the whole gradient tree,
each logical element once.  A rank here holds pieces
(``parallel.placement``): over ``model`` the shards of the tensor-parallel
parameters, over ``expert`` its experts, over ``pipe`` its stage's blocks
(and ``wte``/``ln_f``, whose gradients every stage holds summed), under
``--zero`` its rows; the norm sums each piece once and a replicated
tensor once (``train.optimizers._split_square_sum``).  One training step
(``train.make_train_step``, SGD with ``global_clipnorm`` below the
gradient's norm, so the clip bites) over ``data=1,model=2`` (gpt_tiny),
``data=1,expert=2`` (gpt_moe_tiny), ``data=1,pipe=2`` under GPipe and 1F1B
(gpt_tiny, one block a stage, 8 microbatches) and ``data=2,model=2`` with
ZeRO (four thread ranks) against JAX's: its gradients of the same model
on the same mesh of the conftest's CPU devices (the MoE region and the
pipeline as mesh functions; GSPMD's tensor parallelism computes the
unsharded values), then its ``build_optimizer`` chain (``optax.chain(
clip_by_global_norm, sgd)``).  Each rank's parameters equal its cut of
JAX's updated tree (``models.convert.shards_for_rank``), and over
``pipe`` ``wte`` and ``ln_f`` stay bit-equal across the stages.  fp32.

Tolerance: each parameter within 1e-4 of its update's max-abs (the
gradient tolerance of ``tests/test_torch_sharding.py``; 5e-4 over pipe,
``tests/test_torch_gpt_pipeline.py``'s) plus one fp32 ulp of the
parameter's max-abs (where ``p + u`` rounds).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributedtensorflow_tpu.models import GPTLM as JaxGPTLM
from distributedtensorflow_tpu.models import gpt_moe as jax_gpt_moe
from distributedtensorflow_tpu.models import gpt_tiny as jax_gpt_tiny
from distributedtensorflow_tpu.models import lm_loss as jax_lm_loss
from distributedtensorflow_tpu.models.gpt_pipeline import (
    PipelinedGPT as JaxPipelinedGPT,
)
from distributedtensorflow_tpu.models.gpt_pipeline import (
    pipelined_lm_loss as jax_pipelined_lm_loss,
)
from distributedtensorflow_tpu.parallel import MeshSpec as JMeshSpec
from distributedtensorflow_tpu.parallel import build_mesh as jbuild_mesh
from distributedtensorflow_tpu.parallel import moe as jmoe
from distributedtensorflow_tpu.train import engine as jax_engine
from distributedtensorflow_tpu.train import optimizers as jax_opt
from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch import workloads as tw
from distributedtensorflow_tpu_torch.data import InputContext, device_put_batch
from distributedtensorflow_tpu_torch.parallel.mesh import MeshSpec
from distributedtensorflow_tpu_torch.parallel.zero import ZeroSharder
from distributedtensorflow_tpu_torch.testing import run_mesh
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401
from distributedtensorflow_tpu_torch.train import (
    build_optimizer,
    create_sharded_state,
    make_train_step,
)

LR = 0.5
CLIP = 0.1


def _ids(b=16, s=32, vocab=512, seed=3):
    rng = np.random.default_rng(seed)
    start = rng.integers(0, vocab, size=(b, 1))
    step = rng.integers(1, 7, size=(b, 1))
    return ((start + step * np.arange(s)) % vocab).astype(np.int32)


def _dense(axes, jmesh):
    """gpt_tiny: JAX's flax params, loss and global batches (one a
    replica), and the port's workload."""
    jcfg = dataclasses.replace(jax_gpt_tiny(), dtype=jnp.float32)
    params = jax.device_get(jax.jit(JaxGPTLM(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 64), jnp.int32))["params"])
    pw = tw.get_workload("gpt_lm", test_size=True, global_batch_size=8)
    data = axes["data"]
    batches = [next(pw.input_fn(InputContext(data, r, 8), 0))
               for r in range(data)]
    return params, jax_lm_loss(JaxGPTLM(jcfg)), batches, pw


def _moe(axes, jmesh):
    jcfg = dataclasses.replace(jax_gpt_moe.gpt_moe_tiny(), dtype=jnp.float32)
    params = jax.device_get(jax.jit(jax_gpt_moe.GPTMoELM(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 64), jnp.int32))["params"])
    jmodel = jax_gpt_moe.GPTMoELM(jcfg, jmoe.make_moe_fn(
        jmesh, jax_gpt_moe._expert_mlp, capacity_factor=jcfg.capacity_factor,
        router=jcfg.router))
    pw = tw.get_workload("gpt_moe", test_size=True, global_batch_size=8)
    batches = [next(pw.input_fn(InputContext(1, 0, 8), 0))]
    return params, jax_gpt_moe.moe_lm_loss(jmodel), batches, pw


def _pipe(schedule):
    def make(axes, jmesh):
        jcfg = dataclasses.replace(jax_gpt_tiny(), dtype=jnp.float32)
        pp = JaxPipelinedGPT(jcfg, jmesh, n_microbatches=8, schedule=schedule)
        params = jax.device_get(pp.init(jax.random.PRNGKey(1))["params"])
        pw = tw.get_workload("gpt_lm", test_size=True, global_batch_size=16,
                             seq_len=32, pp_schedule=schedule)
        return params, jax_pipelined_lm_loss(pp), [{"input_ids": _ids()}], pw
    return make


#: (model, mesh axes, --zero)
CASES = {"model2": (_dense, dict(data=1, model=2), False),
         "expert2": (_moe, dict(data=1, expert=2), False),
         "pipe2_gpipe": (_pipe("gpipe"), dict(data=1, pipe=2), False),
         "pipe2_1f1b": (_pipe("1f1b"), dict(data=1, pipe=2), False),
         "data2_model2_zero": (_dense, dict(data=2, model=2), True)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_clipped_step_over_split_axes_matches_jax(name):
    make, axes, use_zero = CASES[name]
    world = int(np.prod(list(axes.values())))
    jmesh = jbuild_mesh(JMeshSpec(**axes), jax.devices()[:world])
    params, jloss, batches, pw = make(axes, jmesh)
    glob = {k: jnp.asarray(np.concatenate([b[k] for b in batches]))
            for k in batches[0]}
    grads = jax.device_get(jax.jit(
        lambda p: jax_engine.accumulate_gradients(
            jloss, p, {}, glob, jax.random.PRNGKey(0), 1)[0])(params))
    assert float(optax.global_norm(grads)) > 2 * CLIP  # the clip bites
    tx = jax_opt.build_optimizer("sgd", LR, global_clipnorm=CLIP)
    updates, _ = tx.update(grads, tx.init(params), params)
    new = jax.device_get(optax.apply_updates(params, updates))
    cfg = dataclasses.replace(pw.cfg, dtype=torch.float32)
    pipe = axes.get("pipe", 1) > 1

    def body(rank, mesh):
        wl = pw.for_mesh(mesh)
        model = wl.model_cls(cfg, device="cpu",
                             **({"group": mesh} if wl.model_takes_group
                                else {}))
        model.load_state_dict(tm.convert.shards_for_rank(
            params, cfg, {"pipe": mesh.coords["pipe"]},
            {"pipe": mesh.shape["pipe"]})["params"])
        zero = ZeroSharder(mesh) if use_zero else None
        state, _ = create_sharded_state(
            model, build_optimizer("sgd", LR, global_clipnorm=CLIP), mesh,
            cfg=cfg, rules=wl.layout, zero=zero)
        step = make_train_step(wl.loss_fn(model, group=mesh), mesh=mesh)
        step(state, device_put_batch(batches[mesh.coords["data"]], "cpu",
                                     mesh))
        want = {k: tm.convert.shards_for_rank(
            tree, cfg, mesh.coords, mesh.shape, layout=wl.layout)["params"]
            for k, tree in (("old", params), ("new", new))}
        return rank, {k: p.detach().clone()
                      for k, p in model.named_parameters()}, want

    outs = run_mesh(body, MeshSpec(**axes), world)
    tol = 5e-4 if pipe else 1e-4
    for rank, got, want in outs:
        assert got.keys() == want["new"].keys()
        for k, ref in want["new"].items():
            old, ref = want["old"][k].numpy(), ref.numpy()
            np.testing.assert_allclose(
                got[k].numpy(), ref, rtol=0, err_msg=f"rank {rank} {k}",
                atol=tol * np.abs(ref - old).max()
                + np.spacing(np.abs(old).max()))
    if pipe:  # the replicated table and final LayerNorm stay one copy
        stages = [got for _, got, _ in sorted(outs, key=lambda o: o[0])]
        for k in ("wte.weight", "ln_f.scale", "ln_f.bias"):
            assert torch.equal(stages[0][k], stages[1][k]), k
