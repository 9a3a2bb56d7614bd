"""ZeRO and the bucketed overlap over the split mesh axes, against JAX's step.

JAX builds one ``ZeroSharder`` and one ``OverlapPlan`` for any mesh
(``train.py:1040-1109``): the optimizer state and the update are sharded
over the batch axes (``data`` x ``fsdp``) only, whatever else the mesh
splits.  Here four thread ranks (``testing.run_mesh``) train two AdamW
steps of gpt_tiny over ``data=2,seq=2`` (ring attention), gpt_moe_tiny
over ``data=2,expert=2`` and gpt_tiny in a pipeline over ``data=2,pipe=2``
(GPipe and 1F1B, one block a stage, 8 microbatches), each with
``--zero``, with ``--overlap`` and with both, from one converted flax
init; the reference is JAX's ``make_train_step`` with a ``ZeroSharder``
and an ``OverlapPlan`` on the same mesh of four of the conftest's CPU
devices.  Each rank's losses equal JAX's, its parameters its cut of
JAX's updated tree (``models.convert.shards_for_rank``), the ranks that
hold one piece hold it bit for bit, and a ZeRO rank keeps half of the
optimizer slots.  Then the reference's own check that 1F1B and GPipe
agree under the same ZeRO + overlap step (``tests/test_gpt_pipeline.py``
``test_1f1b_composes_with_zero_and_overlap``), and the sharder's group
over ``seq``: the batch group, of the ZeRO degree's size (the mesh's
``group`` spans ``seq`` too, and a reduce-scatter of the degree's rows
over it fails).  fp32.

AdamW with ``eps`` 1e-3 on both sides (optax's ``adamw``, the port's
``train.optimizers.adamw``): at optax's 1e-8 the division by each
moment's root magnifies the last bits of a near-zero gradient entry,
summed in another order than JAX's, into a percent of its update, which
the plain ``seq`` step shows as well as the sharded ones.

Tolerances: losses 1e-5 relative; each parameter within 1e-4 of its
update's max-abs (5e-4 over ``pipe``, ``tests/test_torch_gpt_pipeline.py``'s
gradient tolerance) plus one fp32 ulp of the parameter's max-abs, as
``tests/test_torch_clip_split.py``; 1F1B against GPipe 1e-4 relative and
1e-5 absolute, the reference's.
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
from distributedtensorflow_tpu.parallel.overlap import (
    OverlapPlan as JaxOverlapPlan,
)
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
from distributedtensorflow_tpu.train.state import split_variables
from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch import workloads as tw
from distributedtensorflow_tpu_torch.data import InputContext, device_put_batch
from distributedtensorflow_tpu_torch.parallel.collectives import group_size
from distributedtensorflow_tpu_torch.parallel.mesh import MeshSpec
from distributedtensorflow_tpu_torch.parallel.overlap import OverlapPlan
from distributedtensorflow_tpu_torch.parallel.zero import ZeroSharder
from distributedtensorflow_tpu_torch.testing import run_mesh
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401
from distributedtensorflow_tpu_torch.train import (
    create_sharded_state,
    make_train_step,
)
from distributedtensorflow_tpu_torch.train.optimizers import adamw

LR = 1e-2
WD = 0.01
#: AdamW's eps, large beside the gradients' small entries: Adam divides
#: each moment by its own root, so at optax's 1e-8 an entry near zero
#: turns the last bits of its sum (summed in another order over the
#: ranks than JAX's) into a percent of its update
EPS = 1e-3
BUCKET = 64 << 10
STEPS = 2
RTOL = 1e-5


def _ids(b=16, s=32, vocab=512, seed=3):
    rng = np.random.default_rng(seed)
    start = rng.integers(0, vocab, size=(b, 1))
    step = rng.integers(1, 7, size=(b, 1))
    return ((start + step * np.arange(s)) % vocab).astype(np.int32)


def _replica_batches(pw, data, steps):
    """``[step][replica]`` batches of each replica's own pipeline."""
    srcs = [pw.input_fn(InputContext(data, r, pw.global_batch_size), 0)
            for r in range(data)]
    return [[next(src) for src in srcs] for _ in range(steps)]


def _seq(axes, jmesh):
    """gpt_tiny with ring attention over ``seq``: JAX's params, loss and
    the port's workload and batches."""
    jcfg = dataclasses.replace(jax_gpt_tiny(), dtype=jnp.float32)
    params = jax.device_get(jax.jit(JaxGPTLM(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 64), jnp.int32))["params"])
    jloss = jax_lm_loss(JaxGPTLM(jcfg, jax_sp_attention(
        jmesh, scheme="ring", causal=True)))
    pw = tw.get_workload("gpt_lm", test_size=True, sp_scheme="ring",
                         global_batch_size=8)
    return params, jloss, None, pw, _replica_batches(pw, axes["data"],
                                                     STEPS)


def _moe(axes, jmesh):
    jcfg = dataclasses.replace(jax_gpt_moe.gpt_moe_tiny(), dtype=jnp.float32)
    params = jax.device_get(jax.jit(jax_gpt_moe.GPTMoELM(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 64), jnp.int32))["params"])
    jmodel = jax_gpt_moe.GPTMoELM(jcfg, jmoe.make_moe_fn(
        jmesh, jax_gpt_moe._expert_mlp, capacity_factor=jcfg.capacity_factor,
        router=jcfg.router))
    pw = tw.get_workload("gpt_moe", test_size=True, global_batch_size=8)
    return (params, jax_gpt_moe.moe_lm_loss(jmodel), None, pw,
            _replica_batches(pw, axes["data"], STEPS))


def _pipe(schedule, n_micro=8):
    def make(axes, jmesh):
        jcfg = dataclasses.replace(jax_gpt_tiny(), dtype=jnp.float32)
        pp = JaxPipelinedGPT(jcfg, jmesh, n_microbatches=n_micro,
                             schedule=schedule)
        params = jax.device_get(pp.init(jax.random.PRNGKey(1))["params"])
        pw = tw.get_workload("gpt_lm", test_size=True, global_batch_size=16,
                             seq_len=32, pp_schedule=schedule)
        data = axes["data"]
        batches = []
        for i in range(STEPS):
            ids = _ids(seed=3 + i)
            batches.append([{"input_ids": part}
                            for part in np.split(ids, data)])
        return params, jax_pipelined_lm_loss(pp), pp.layout(), pw, batches
    return make


#: (model, mesh axes)
CASES = {"seq2_ring": (_seq, dict(data=2, seq=2)),
         "expert2": (_moe, dict(data=2, expert=2)),
         "pipe2_gpipe": (_pipe("gpipe"), dict(data=2, pipe=2)),
         "pipe2_1f1b": (_pipe("1f1b"), dict(data=2, pipe=2))}
#: (--zero, --overlap)
FLAGS = {"zero": (True, False), "overlap": (False, True),
         "zero_overlap": (True, True)}


def _jax_steps(params, jloss, rules, jmesh, batches, steps=STEPS):
    """JAX's ZeRO + overlap step (``train.py``'s setup) over ``jmesh``:
    ``(losses, new params)``."""
    tx = optax.adamw(LR, eps=EPS, weight_decay=WD)
    zero = JaxZeroSharder(jmesh)

    def init(rng):
        return {"params": params}

    state, specs = jax_create_sharded_state(
        init, tx, jmesh, jax.random.PRNGKey(0), rules=rules, zero=zero)
    shapes, _ = split_variables(jax.eval_shape(init, jax.random.PRNGKey(0)))
    plan = JaxOverlapPlan.build(jmesh, shapes, specs.params, zero=zero,
                                bucket_bytes=BUCKET)
    step = jax_engine.make_train_step(jloss, jmesh, specs, overlap=plan)
    losses = []
    for i in range(steps):
        glob = {k: jnp.asarray(np.concatenate([b[k] for b in batches[i]]))
                for k in batches[i][0]}
        state, m = step(state, glob, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    return losses, jax.device_get(state.params)


def _port_steps(pw, params, axes, batches, use_zero, use_overlap,
                steps=STEPS):
    """Each rank's ``(coords, losses, parameters, slot elements, plan,
    layout)`` after ``steps`` of the port's step over ``axes``."""
    cfg = dataclasses.replace(pw.cfg, dtype=torch.float32)

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
            model, lambda named: adamw(named, LR, eps=EPS, weight_decay=WD),
            mesh,
            cfg=cfg, rules=wl.layout, zero=zero)
        early = []  # launches made before the engine's backward began
        if use_overlap:
            plan = state.overlap = OverlapPlan.build(
                model, mesh, zero=zero, paths=tm.flax_paths(cfg),
                bucket_bytes=BUCKET)
            launch = plan._launch
            plan._launch = lambda b: (early.append(not plan._active),
                                      launch(b))
        step = make_train_step(wl.loss_fn(model, group=mesh), mesh=mesh)
        losses = []
        for i in range(steps):
            state, m = step(state, device_put_batch(
                batches[i][mesh.coords["data"]], "cpu", mesh))
            losses.append(float(m["loss"]))
        slots = sum(v.numel() for st in state.optimizer.state.values()
                    for v in st.values() if torch.is_tensor(v) and v.dim())
        plan = dict(state.overlap.describe(), early=sum(early)) \
            if state.overlap else None
        return (dict(mesh.coords), losses,
                {k: p.detach().clone() for k, p in model.named_parameters()},
                slots, plan, wl.layout)

    return run_mesh(body, MeshSpec(**axes), int(np.prod(list(axes.values()))))


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's run of each case, made once for the three flag sets."""
    out = {}

    def get(name):
        if name not in out:
            make, axes = CASES[name]
            world = int(np.prod(list(axes.values())))
            jmesh = jbuild_mesh(JMeshSpec(**axes), jax.devices()[:world])
            params, jloss, rules, pw, batches = make(axes, jmesh)
            losses, new = _jax_steps(params, jloss, rules, jmesh, batches)
            out[name] = (params, pw, batches, losses, new)
        return out[name]

    return get


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("name", sorted(CASES))
def test_zero_overlap_step_over_split_axes_matches_jax(jax_refs, name,
                                                       flags):
    _, axes = CASES[name]
    use_zero, use_overlap = FLAGS[flags]
    params, pw, batches, jlosses, new = jax_refs(name)
    outs = _port_steps(pw, params, axes, batches, use_zero, use_overlap)
    cfg = dataclasses.replace(pw.cfg, dtype=torch.float32)
    pipe = axes.get("pipe", 1) > 1
    tol = 5e-4 if pipe else 1e-4
    for coords, losses, got, slots, plan, layout in outs:
        np.testing.assert_allclose(losses, jlosses, rtol=RTOL)
        shape = {a: axes.get(a, 1) for a in coords}
        want = {k: tm.convert.shards_for_rank(
            tree, cfg, coords, shape, layout=layout)["params"]
            for k, tree in (("old", params), ("new", new))}
        assert got.keys() == want["new"].keys()
        for k, ref in want["new"].items():
            old, ref = want["old"][k].numpy(), ref.numpy()
            np.testing.assert_allclose(
                got[k].numpy(), ref, rtol=0, err_msg=f"{coords} {k}",
                atol=tol * np.abs(ref - old).max()
                + np.spacing(np.abs(old).max()))
        if use_overlap:
            assert plan["buckets"] > 1 and plan["coverage"] == 1.0
            assert plan["mode"] == ("reduce_scatter" if use_zero
                                    else "all_reduce")
            assert plan.get("pipe") == ("schedule" if pipe else None)
            # a stage's block buckets go out from the schedule, inside the
            # loss's forward; a dense model's all in the backward
            assert (plan["early"] > 0) == pipe
    # the ranks that hold one piece (a replica's data and seq ranks) hold
    # it bit for bit
    by_piece = {}
    for coords, _, got, slots, _, _ in outs:
        key = (coords["pipe"], coords["expert"])
        if key in by_piece:
            ref = by_piece[key]
            for k in ref:
                assert torch.equal(got[k], ref[k]), (coords, k)
        else:
            by_piece[key] = got
        if use_zero:  # half the rows of every slot, each padded once
            n = sum(p.numel() for p in got.values())
            assert n <= slots <= n + 2 * 2 * len(got)


def test_1f1b_composes_with_zero_and_overlap():
    """``--zero`` and ``--overlap`` stack on the fb loss: 1F1B's
    trajectory matches GPipe's under the same ZeRO + overlap step, four
    steps, and the loss falls (the reference's
    ``test_1f1b_composes_with_zero_and_overlap``)."""
    jcfg = dataclasses.replace(jax_gpt_tiny(), dtype=jnp.float32)
    jmesh = jbuild_mesh(JMeshSpec(data=2, pipe=2), jax.devices()[:4])
    params = jax.device_get(JaxPipelinedGPT(
        jcfg, jmesh, n_microbatches=4).init(jax.random.PRNGKey(0))["params"])
    batches = [[{"input_ids": part} for part in
                np.split(_ids(seed=i), 2)] for i in range(4)]

    def run(schedule):
        pw = tw.get_workload("gpt_lm", test_size=True, global_batch_size=16,
                             seq_len=32, pp_schedule=schedule)
        outs = _port_steps(pw, params, dict(data=2, pipe=2), batches, True,
                           True, steps=4)
        return [losses for _, losses, _, _, _, _ in outs]

    for l_g, l_f in zip(run("gpipe"), run("1f1b")):
        np.testing.assert_allclose(l_f, l_g, rtol=1e-4, atol=1e-5)
        assert l_f[-1] < l_f[0]


def test_zero_group_over_seq_is_the_batch_group():
    """Over ``data=2,seq=2`` the sharder's degree counts the batch axes
    (2) and its group is theirs, of that size, with this rank's replica
    index as its rank there; ``seq_group`` sums a replica's shares
    first.  The mesh's ``group`` spans ``seq`` as well (4 ranks)."""

    def body(rank, mesh):
        z = ZeroSharder(mesh)
        return (z.degree, group_size(z.group), group_size(mesh.group),
                group_size(getattr(z, "seq_group", None)), z.rank,
                mesh.coords["data"])

    for degree, size, whole, seq, row, data in run_mesh(
            body, MeshSpec(data=2, seq=2), 4):
        assert (degree, size, whole, seq) == (2, 2, 4, 2)
        assert row == data
