"""Training dynamics over the split mesh axes and under ZeRO, against JAX.

JAX's ``cadence_stats`` reads global arrays: each module's gradient and
parameter norms, update ratios and non-finite counts are of the whole
logical tensors, whatever the mesh splits.  A rank here holds pieces
(the shards of the tensor-parallel parameters over ``model``, its
experts over ``expert``, its stage's blocks over ``pipe``, its rows
under ``--zero``); ``obs.dynamics.StepStats`` sums each piece over its
group and counts a replicated tensor once (``stat_split``).  One step
of ``make_train_step(dynamics_every=1)`` on thread ranks over
``data=1,seq=2`` (gpt_tiny, ring attention), ``data=1,model=2``
(gpt_tiny), ``data=1,expert=2`` (gpt_moe_tiny), ``data=1,pipe=2``
(gpt_tiny under 1F1B, grouped as JAX's pipelined tree: ``blocks``,
``ln_f``, ``wte``) and ``data=2`` with ZeRO, against JAX's
``make_train_step(dynamics_every=1)`` on the same mesh of the conftest's
CPU devices (with JAX's ``ZeroSharder`` for the ZeRO case): the same
keys, the values within the tolerances below, and every rank's values
bit-equal to the others'.  Before this, over ``model`` each rank
reported its own shards' norms.  Then provenance over ``pipe``: a
poisoned block makes every gradient non-finite, the ranks agree on the
pass at the log boundary, each names the module, and only the chief
(the one rank with a logdir) writes the incident.

AdamW with ``eps`` 1e-3 (``tests/test_torch_zero_split.py`` says why).
Tolerances (fp32): gradient and parameter norms 1e-5 relative, update
ratios 1e-4 relative (an update's norm carries its gradient's rounding
through Adam's division), non-finite counts exactly.
"""

import dataclasses
import json
import os

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
from distributedtensorflow_tpu.parallel.ring_attention import (
    sequence_parallel_attention_fn as jax_sp_attention,
)
from distributedtensorflow_tpu.parallel.zero import (
    ZeroSharder as JaxZeroSharder,
)
from distributedtensorflow_tpu.train import engine as jax_engine
from distributedtensorflow_tpu.train.state import (
    create_sharded_state as jax_create_sharded_state,
)
from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch import workloads as tw
from distributedtensorflow_tpu_torch.data import InputContext, device_put_batch
from distributedtensorflow_tpu_torch.models.gpt_pipeline import (
    pipeline_modules,
)
from distributedtensorflow_tpu_torch.obs import dynamics as dyn
from distributedtensorflow_tpu_torch.parallel.mesh import MeshSpec
from distributedtensorflow_tpu_torch.parallel.zero import ZeroSharder
from distributedtensorflow_tpu_torch.testing import run_mesh
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401
from distributedtensorflow_tpu_torch.train import (
    create_sharded_state,
    make_train_step,
)
from distributedtensorflow_tpu_torch.train.optimizers import adamw

LR = 1e-2
EPS = 1e-3
RTOL = {"grad_norm": 1e-5, "param_norm": 1e-5, "global_grad_norm": 1e-5,
        "update_ratio": 1e-4}


def _ids(b=16, s=32, vocab=512, seed=3):
    rng = np.random.default_rng(seed)
    start = rng.integers(0, vocab, size=(b, 1))
    step = rng.integers(1, 7, size=(b, 1))
    return ((start + step * np.arange(s)) % vocab).astype(np.int32)


def _gpt_params():
    jcfg = dataclasses.replace(jax_gpt_tiny(), dtype=jnp.float32)
    return jcfg, jax.device_get(jax.jit(JaxGPTLM(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 64), jnp.int32))["params"])


def _batches(pw, data):
    return [next(pw.input_fn(InputContext(data, r, pw.global_batch_size), 0))
            for r in range(data)]


def _seq(axes, jmesh):
    jcfg, params = _gpt_params()
    pw = tw.get_workload("gpt_lm", test_size=True, sp_scheme="ring",
                         global_batch_size=8)
    return (params, jax_lm_loss(JaxGPTLM(jcfg, jax_sp_attention(
        jmesh, scheme="ring", causal=True))), None, pw, _batches(pw, 1),
        tm.flax_modules)


def _dense(axes, jmesh):
    jcfg, params = _gpt_params()
    pw = tw.get_workload("gpt_lm", test_size=True, global_batch_size=8)
    return (params, jax_lm_loss(JaxGPTLM(jcfg)), None, pw,
            _batches(pw, axes["data"]), tm.flax_modules)


def _moe(axes, jmesh):
    jcfg = dataclasses.replace(jax_gpt_moe.gpt_moe_tiny(), dtype=jnp.float32)
    params = jax.device_get(jax.jit(jax_gpt_moe.GPTMoELM(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 64), jnp.int32))["params"])
    jmodel = jax_gpt_moe.GPTMoELM(jcfg, jmoe.make_moe_fn(
        jmesh, jax_gpt_moe._expert_mlp, capacity_factor=jcfg.capacity_factor,
        router=jcfg.router))
    pw = tw.get_workload("gpt_moe", test_size=True, global_batch_size=8)
    return (params, jax_gpt_moe.moe_lm_loss(jmodel), None, pw,
            _batches(pw, 1), tm.flax_modules)


def _pipe(axes, jmesh):
    jcfg = dataclasses.replace(jax_gpt_tiny(), dtype=jnp.float32)
    pp = JaxPipelinedGPT(jcfg, jmesh, n_microbatches=8, schedule="1f1b")
    params = jax.device_get(pp.init(jax.random.PRNGKey(1))["params"])
    pw = tw.get_workload("gpt_lm", test_size=True, global_batch_size=16,
                         seq_len=32, pp_schedule="1f1b")
    return (params, jax_pipelined_lm_loss(pp), pp.layout(), pw,
            [{"input_ids": _ids()}], pipeline_modules)


#: (model, mesh axes, --zero)
CASES = {"seq2": (_seq, dict(data=1, seq=2), False),
         "model2": (_dense, dict(data=1, model=2), False),
         "expert2": (_moe, dict(data=1, expert=2), False),
         "pipe2_1f1b": (_pipe, dict(data=1, pipe=2), False),
         "data2_zero": (_dense, dict(data=2), True)}


def _jax_stats(params, jloss, rules, jmesh, batches, use_zero):
    """The ``dynamics/`` metrics of JAX's step with ``dynamics_every=1``
    on ``jmesh``."""
    tx = optax.adamw(LR, eps=EPS)
    zero = JaxZeroSharder(jmesh) if use_zero else None
    state, specs = jax_create_sharded_state(
        lambda rng: {"params": params}, tx, jmesh, jax.random.PRNGKey(0),
        rules=rules, zero=zero)
    step = jax_engine.make_train_step(jloss, jmesh, specs, dynamics_every=1)
    glob = {k: jnp.asarray(np.concatenate([b[k] for b in batches]))
            for k in batches[0]}
    _, m = step(state, glob, jax.random.PRNGKey(0))
    return {k: float(v) for k, v in jax.device_get(m).items()
            if k.startswith(dyn.METRIC_PREFIX)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_dynamics_over_split_axes_match_jax(name):
    make, axes, use_zero = CASES[name]
    world = int(np.prod(list(axes.values())))
    jmesh = jbuild_mesh(JMeshSpec(**axes), jax.devices()[:world])
    params, jloss, rules, pw, batches, modules = make(axes, jmesh)
    want = _jax_stats(params, jloss, rules, jmesh, batches, use_zero)
    cfg = dataclasses.replace(pw.cfg, dtype=torch.float32)

    def body(rank, mesh):
        wl = pw.for_mesh(mesh)
        model = wl.model_cls(cfg, device="cpu",
                             **({"group": mesh} if wl.model_takes_group
                                else {}))
        model.load_state_dict(tm.convert.shards_for_rank(
            params, cfg, {"pipe": mesh.coords["pipe"]},
            {"pipe": mesh.shape["pipe"]})["params"])
        state, _ = create_sharded_state(
            model, lambda named: adamw(named, LR, eps=EPS), mesh, cfg=cfg,
            rules=wl.layout, zero=ZeroSharder(mesh) if use_zero else None)
        step = make_train_step(wl.loss_fn(model, group=mesh), mesh=mesh,
                               dynamics_every=1,
                               dynamics_modules=modules(cfg))
        _, m = step(state, device_put_batch(batches[mesh.coords["data"]],
                                            "cpu", mesh))
        return {k: v.clone() for k, v in m.items()
                if k.startswith(dyn.METRIC_PREFIX)}

    outs = run_mesh(body, MeshSpec(**axes), world)
    for got in outs:
        assert got.keys() == want.keys()
        for k, ref in want.items():
            stat = k[len(dyn.METRIC_PREFIX):].split("/")[0]
            if stat == "nonfinite":
                assert float(got[k]) == ref == 0.0, k
            else:
                np.testing.assert_allclose(float(got[k]), ref,
                                           rtol=RTOL[stat], err_msg=k)
        for k in got:  # every rank holds the same values, bit for bit
            assert torch.equal(got[k], outs[0][k]), k


def test_provenance_over_pipe_agrees_and_the_chief_writes(tmp_path):
    """``data=1,pipe=2`` (1F1B), ``h.1``'s MLP weight poisoned on the
    stage that holds it: the step's rows carry non-finite gradient
    counts, both ranks enter the pass at the log boundary and name the
    same module, and only the chief's logdir holds the incident (one)."""
    pw = tw.get_workload("gpt_lm", test_size=True, global_batch_size=16,
                         seq_len=32, pp_schedule="1f1b")
    cfg = dataclasses.replace(pw.cfg, dtype=torch.float32)
    batch = {"input_ids": _ids()}

    def body(rank, mesh):
        wl = pw.for_mesh(mesh)
        model = wl.model_cls(cfg, device="cpu")
        model.load_state_dict(wl.init_params(
            cfg, torch.Generator().manual_seed(0)))
        state, _ = create_sharded_state(
            model, wl.make_optimizer, mesh, cfg=cfg, rules=wl.layout)
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n.startswith("h.1.") and p.dim() == 2:
                    p.fill_(float("nan"))
        loss_fn = wl.loss_fn(model, group=mesh)
        logdir = str(tmp_path / f"rank{rank}")
        mon = dyn.DynamicsMonitor(
            1, logdir=logdir if rank == 0 else None, loss_fn=loss_fn,
            modules=pipeline_modules(cfg), log_every=1, mesh=mesh)
        step = mon.wrap_train_step(make_train_step(
            loss_fn, mesh=mesh, dynamics_every=1,
            dynamics_modules=pipeline_modules(cfg)))
        mon.on_fit_begin(None, state)
        state, m = step(state, device_put_batch(batch, "cpu", mesh))
        mon.on_step_end(None, 1, state, m)
        mon.on_fit_end(None, state)
        mon.close()
        return rank, mon.last_prov, logdir

    docs = run_mesh(body, MeshSpec(data=1, pipe=2), 2)
    assert [d["module"] for _, d, _ in docs] == ["blocks", "blocks"]
    assert {d["reason"] for _, d, _ in docs} == {"non_finite_grads"}
    for rank, doc, logdir in docs:
        incidents = os.path.join(logdir, "incidents")
        if rank == 0:
            assert os.listdir(incidents) == ["0001-nan_provenance"]
            with open(os.path.join(incidents, "0001-nan_provenance",
                                   "provenance.json")) as f:
                assert json.load(f)["module"] == "blocks"
        else:
            assert not os.path.exists(logdir)
