"""The sequence-parallel training step of the GPT LMs against JAX's.

``gpt_lm`` at test size (gpt_tiny, seq 64, global batch 8, fp32) bound
to a ``seq`` mesh by the preset's ``for_mesh`` (ring or Ulysses
attention, ``--sp-scheme``): each ``seq`` rank runs its contiguous half
of the sequence through the whole block stack, its loss is its share of
the global mean (the targets shifted on the whole sequence, the rotary
positions from the chunk's offset), and the engine sums the gradients
over ``data`` x ``seq``.  At ``data=1,seq=2`` (two thread ranks) and
``data=2,seq=2`` (four) the loss and every gradient match JAX's step on
the global batch with the same sequence-parallel model on the same mesh
(``GPTLM(cfg, sequence_parallel_attention_fn(mesh, ...))``), from one
flax init; so do they at ``data=1,seq=2,model=2`` (four ranks: the
dense layers and the vocabulary-parallel head split over ``model``,
each model rank's ring or Ulysses turning only its own heads).  Then the flags: ``--sp-scheme`` reaches the preset, and the
presets that do not split the sequence refuse a ``seq`` axis.

Tolerances: losses 1e-5 relative; gradients 1e-4 of each leaf's max-abs
(as ``tests/test_torch_dp.py``).
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
from distributedtensorflow_tpu.parallel import MeshSpec as JMeshSpec
from distributedtensorflow_tpu.parallel import build_mesh as jbuild_mesh
from distributedtensorflow_tpu.parallel.ring_attention import (
    sequence_parallel_attention_fn as jax_sp_attention,
)
from distributedtensorflow_tpu.train import engine as jax_engine
from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch import workloads as tw
from distributedtensorflow_tpu_torch.data import InputContext, device_put_batch
from distributedtensorflow_tpu_torch.parallel.mesh import MeshSpec
from distributedtensorflow_tpu_torch.parallel.ring_attention import (
    SequenceParallelAttention,
)
from distributedtensorflow_tpu_torch.testing import run_mesh
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401
from distributedtensorflow_tpu_torch.train.engine import (
    accumulate_gradients_dp,
)
import train_torch

RTOL = 1e-5
GRAD_TOL = 1e-4
BATCH = 8


def _flat(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), np.asarray(val)


@pytest.fixture(scope="module")
def init():
    jcfg = dataclasses.replace(jax_gpt_tiny(), dtype=jnp.float32)
    params = jax.device_get(jax.jit(JaxGPTLM(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 64), jnp.int32))["params"])
    return jcfg, params


@pytest.mark.parametrize("data", [1, 2])
@pytest.mark.parametrize("scheme", ["ring", "ulysses"])
def test_seq2_step_matches_jax(init, scheme, data):
    jcfg, params = init
    pw = tw.get_workload("gpt_lm", test_size=True, sp_scheme=scheme,
                         global_batch_size=BATCH)
    tcfg = dataclasses.replace(pw.cfg, dtype=torch.float32)
    batches = [next(pw.input_fn(InputContext(data, r, BATCH), 0))
               for r in range(data)]
    glob = {k: jnp.asarray(np.concatenate([b[k] for b in batches]))
            for k in batches[0]}
    jmesh = jbuild_mesh(JMeshSpec(data=data, seq=2), jax.devices()[:2 * data])
    jloss = jax_lm_loss(JaxGPTLM(jcfg, jax_sp_attention(
        jmesh, scheme=scheme, causal=True)))
    rng = jax.random.PRNGKey(0)
    jl = float(jax.jit(lambda p: jloss(p, {}, glob, rng)[0])(params))
    jgrads = jax.device_get(jax.jit(
        lambda p: jax_engine.accumulate_gradients(jloss, p, {}, glob, rng,
                                                  1)[0])(params))
    whole = tm.params_from_flax(params, tcfg)

    def body(rank, mesh):
        wl = pw.for_mesh(mesh)
        model = wl.model_cls(tcfg, device="cpu")
        assert isinstance(model.attn_fn, SequenceParallelAttention)
        assert model.attn_fn.scheme == scheme
        model.load_state_dict(whole)
        batch = device_put_batch(batches[mesh.coords["data"]], "cpu", mesh)
        grads, metrics = accumulate_gradients_dp(
            wl.loss_fn(model, group=mesh), model, batch, mesh, seed=0,
            step=0)
        return float(metrics["loss"]), grads

    outs = run_mesh(body, MeshSpec(data=data, seq=2), 2 * data)
    ref = dict(_flat(jgrads))
    for loss, grads in outs:
        np.testing.assert_allclose(loss, jl, rtol=RTOL)
        got = dict(_flat(tm.params_to_flax(grads, tcfg)))
        assert got.keys() == ref.keys()
        for path, r in ref.items():
            np.testing.assert_allclose(got[path], r, rtol=0,
                                       atol=GRAD_TOL * np.abs(r).max(),
                                       err_msg=path)


def test_sequence_slice_shifts_before_it_cuts():
    """A rank's targets are the next tokens of the whole sequence: the
    first rank's last target is the second rank's first token, and the
    last position of the sequence has none (-1, weight 0)."""
    ids = torch.arange(16).reshape(2, 8)
    mask = torch.ones(2, 8)
    parts = [tm.gpt.sequence_slice(ids, ids[:, 1:], mask[:, 1:], r, 2)
             for r in range(2)]
    (ids0, pos0, t0, m0), (ids1, pos1, t1, m1) = parts
    assert ids0.tolist() == [[0, 1, 2, 3], [8, 9, 10, 11]]
    assert pos1.tolist() == [[4, 5, 6, 7]] * 2
    assert t0[:, -1].tolist() == ids1[:, 0].tolist()
    assert t1.tolist() == [[5, 6, 7, -1], [13, 14, 15, -1]]
    assert m1[:, -1].tolist() == [0.0, 0.0] and m0.min() == 1


def test_sequence_parallel_flags_and_refusals():
    """``--sp-scheme`` picks the attention; a preset that does not split
    the sequence refuses a ``seq`` axis (JAX would run it replicated);
    ``--steps-per-call`` > 1 over a ``seq`` or ``expert`` axis exits "not
    ported", while ``--zero``, ``--overlap`` and ``--dynamics-every``
    (refused until PR 22) pass the checks."""
    args = train_torch.parse_args(["--test-size", "--device", "cpu",
                                   "--workload", "gpt_lm", "--mesh",
                                   "data=1,seq=2", "--sp-scheme", "ulysses"])
    assert args.sp_scheme == "ulysses"
    train_torch.check_flags(args)  # runs
    for mesh in ("data=2,seq=2", "data=2,expert=2"):
        base = ["--test-size", "--device", "cpu", "--mesh", mesh]
        for flags in (["--zero"], ["--overlap"], ["--zero", "--overlap"],
                      ["--dynamics-every", "1"],
                      ["--zero", "--dynamics-every", "1"]):
            train_torch.check_flags(train_torch.parse_args(base + flags))
        with pytest.raises(SystemExit, match="--steps-per-call > 1 over"):
            train_torch.check_flags(train_torch.parse_args(
                base + ["--steps-per-call", "2"]))
    with pytest.raises(ValueError, match="sp_scheme"):
        tw.get_workload("gpt_lm", test_size=True, sp_scheme="tree")

    def bind(rank, mesh):
        out = {}
        for name in ("gpt_lm", "lm_long_context", "gpt_moe", "bert_mlm"):
            try:
                wl = tw.get_workload(name, test_size=True).for_mesh(mesh)
                out[name] = wl.model_cls.func.__name__
            except NotImplementedError as e:
                out[name] = str(e)
        return out

    for got in run_mesh(bind, MeshSpec(data=1, seq=2), 2):
        assert got["gpt_lm"] == got["lm_long_context"] == "GPTLM"
        for name in ("gpt_moe", "bert_mlm"):
            assert "over a seq axis is not ported" in got[name]


@pytest.mark.parametrize("scheme", ["ring", "ulysses"])
def test_seq2_model2_step_matches_jax(init, scheme):
    """``data=1,seq=2,model=2`` (four thread ranks): the dense layers and
    the heads split over ``model`` (the preset's layout, through
    ``create_sharded_state``), each model rank's ring or Ulysses turning
    only its own heads over ``seq``; the loss and the gradients, the
    model shards put together, against JAX's step on the same mesh."""
    from distributedtensorflow_tpu_torch.parallel import sharding
    from distributedtensorflow_tpu_torch.train.state import (
        create_sharded_state,
    )

    jcfg, params = init
    pw = tw.get_workload("gpt_lm", test_size=True, sp_scheme=scheme,
                         global_batch_size=BATCH)
    tcfg = dataclasses.replace(pw.cfg, dtype=torch.float32)
    batch = next(pw.input_fn(InputContext(1, 0, BATCH), 0))
    glob = {k: jnp.asarray(v) for k, v in batch.items()}
    jmesh = jbuild_mesh(JMeshSpec(seq=2, model=2), jax.devices()[:4])
    jloss = jax_lm_loss(JaxGPTLM(jcfg, jax_sp_attention(
        jmesh, scheme=scheme, causal=True)))
    rng = jax.random.PRNGKey(0)
    jl = float(jax.jit(lambda p: jloss(p, {}, glob, rng)[0])(params))
    jgrads = jax.device_get(jax.jit(
        lambda p: jax_engine.accumulate_gradients(jloss, p, {}, glob, rng,
                                                  1)[0])(params))
    whole = tm.params_from_flax(params, tcfg)

    def body(rank, mesh):
        wl = pw.for_mesh(mesh)
        model = wl.model_cls(tcfg, device="cpu")
        assert isinstance(model.attn_fn, SequenceParallelAttention)
        model.load_state_dict(whole)
        create_sharded_state(model, wl.make_optimizer, mesh, cfg=tcfg,
                             rules=wl.layout)
        grads, metrics = accumulate_gradients_dp(
            wl.loss_fn(model, group=mesh), model,
            device_put_batch(batch, "cpu", mesh), mesh, seed=0, step=0)
        return mesh.coords, float(metrics["loss"]), grads

    outs = run_mesh(body, MeshSpec(data=1, seq=2, model=2), 4)
    rules = sharding.tp_rules(pw.model_cls(tcfg, device="meta"), tcfg,
                              pw.layout)
    assert rules  # the dense layers were cut
    ref = dict(_flat(jgrads))
    for s in range(2):
        by = {c["model"]: g for c, _, g in outs if c["seq"] == s}
        got = dict(_flat(tm.params_to_flax(
            sharding.unshard_states([by[0], by[1]], rules), tcfg)))
        assert got.keys() == ref.keys()
        for path, r in ref.items():
            np.testing.assert_allclose(got[path], r, rtol=0,
                                       atol=GRAD_TOL * np.abs(r).max(),
                                       err_msg=path)
    for _, loss, _ in outs:
        np.testing.assert_allclose(loss, jl, rtol=RTOL)
