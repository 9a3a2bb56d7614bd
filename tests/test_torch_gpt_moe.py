"""The port's GPT-MoE LM, its loss and its training preset against JAX's.

Both packages run ``gpt_moe_tiny`` (2 blocks: 1 dense, 1 MoE with 4
experts) from one seeded JAX init, moved across with ``params_from_flax``;
fp32 unless a test says otherwise.  On the CPU the port takes its
kernels' plain twins, the JAX side its interpret-mode kernels
(``attn_impl="pallas"``) or its XLA path (``"auto"``).
"""

import dataclasses

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
from distributedtensorflow_tpu.models import gpt_moe as jax_gpt_moe
from distributedtensorflow_tpu.models.gpt_moe import GPTMoELM as JaxGPTMoELM
from distributedtensorflow_tpu.models.gpt_moe import (
    gpt_moe_tiny as jax_gpt_moe_tiny,
)
from distributedtensorflow_tpu.models.gpt_moe import (
    moe_lm_loss as jax_moe_lm_loss,
)
from distributedtensorflow_tpu.train.engine import _step_body
from distributedtensorflow_tpu.train.state import TrainState as JaxTrainState
from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch import workloads as tw
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401

VARIANTS = {
    "top2": {},
    "top1": dict(router="top1"),
    "remat_capacity_half": dict(remat=True, capacity_factor=0.5),
    "remat_attn_flash_gqa": dict(remat_attn=True, attn_impl="pallas",
                                 num_kv_heads=2),
}


def _flat(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def _pair(variant, seq=64):
    kw = VARIANTS[variant]
    jcfg = dataclasses.replace(jax_gpt_moe_tiny(), dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(tm.gpt_moe_tiny(), dtype=torch.float32, **kw)
    params = jax.jit(JaxGPTMoELM(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((2, seq), jnp.int32))["params"]
    model = tm.GPTMoELM(tcfg, device="cpu")
    model.load_state_dict(tm.params_from_flax(params, tcfg))
    return jcfg, params, model


def _ids(seed=1, shape=(2, 64)):
    return np.random.default_rng(seed).integers(0, 512, shape)


def test_params_round_trip():
    """flax tree -> port state -> flax tree is bit-identical, the MoE
    block's ``moe_mlp`` leaves keep their flax shapes, and a wrong tree
    or state is refused."""
    _, params, model = _pair("top2")
    cfg = model.cfg
    state = tm.params_from_flax(params, cfg)
    assert state["h.1.moe_mlp.experts_in"].shape == (4, 128, 256)
    assert state["h.1.moe_mlp.router"].shape == (128, 4)
    assert "h.0.fc_in.weight" in state and "h.1.fc_in.weight" not in state
    back = dict(_flat(tm.params_to_flax(state, cfg)))
    ref = dict(_flat(params))
    assert back.keys() == ref.keys()
    for path, arr in ref.items():
        np.testing.assert_array_equal(back[path], arr)
    with pytest.raises(ValueError, match="unexpected"):
        tm.params_to_flax({**state, "h.1.fc_in.weight": torch.zeros(1)}, cfg)
    gpt_tree = {k: v for k, v in params.items() if k != "h1"}
    with pytest.raises(ValueError, match="no h1"):
        tm.params_from_flax(gpt_tree, cfg)
    seeded = tm.init_params(cfg, torch.Generator().manual_seed(0))
    assert seeded.keys() == state.keys()
    assert abs(float(seeded["h.1.moe_mlp.router"].std()) - 0.02) < 0.005


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_logits_and_aux_match_jax(variant):
    jcfg, params, model = _pair(variant)
    ids = _ids()
    jlogits, jaux = jax.jit(JaxGPTMoELM(jcfg).apply)({"params": params},
                                                      jnp.asarray(ids))
    logits, aux = model(torch.as_tensor(ids))
    assert logits.dtype == torch.float32 and logits.shape == (2, 64, 512)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_grads_match_jax(variant):
    """``moe_lm_loss`` (the LM loss plus 0.01 x the routers' aux loss):
    the loss to 1e-5 relative, its metrics, and every gradient leaf
    (mapped back with ``params_to_flax``) to atol 1e-4."""
    jcfg, params, model = _pair(variant)
    ids = _ids(seed=2)
    loss_fn = jax_moe_lm_loss(JaxGPTMoELM(jcfg))

    @jax.jit
    def jax_vg(p):
        return jax.value_and_grad(lambda p: loss_fn(
            p, {}, {"input_ids": jnp.asarray(ids)}, jax.random.PRNGKey(0)),
            has_aux=True)(p)

    (jloss, (jmetrics, _)), jgrads = jax_vg(params)
    loss, metrics = tm.moe_lm_loss(model)({"input_ids": torch.as_tensor(ids)})
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for key in ("perplexity", "aux_loss"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(jmetrics[key]), rtol=1e-5)
    got = dict(_flat(tm.params_to_flax(dict(zip(names, grads)), model.cfg)))
    ref = dict(_flat(jax.tree.map(np.asarray, jgrads)))
    assert got.keys() == ref.keys()
    for path, r in ref.items():
        np.testing.assert_allclose(got[path], r, rtol=0, atol=1e-4,
                                   err_msg="/".join(path))
    evaluated = tm.moe_lm_eval(model)({"input_ids": torch.as_tensor(ids)})
    np.testing.assert_allclose(float(evaluated["loss"]),
                               np.log(float(jmetrics["perplexity"])),
                               rtol=1e-5)


def test_config_choices():
    """expert_choice is refused (non-causal), as in JAX; the MoE layers
    are the last of each group of ``moe_every_k``."""
    cfg = tm.gpt_moe_tiny()
    with pytest.raises(ValueError, match="non-causal"):
        tm.GPTMoELM(dataclasses.replace(cfg, router="expert_choice"),
                    device="cpu")
    deep = dataclasses.replace(cfg, num_layers=6, moe_every_k=3)
    model = tm.GPTMoELM(deep, device="cpu")
    kinds = [type(b).__name__ for b in model.h]
    assert kinds == ["GPTBlock", "GPTBlock", "MoEGPTBlock"] * 2


@pytest.mark.parametrize("test_size", [False, True])
def test_get_workload_matches_jax(test_size):
    jw = jax_workloads.get_workload("gpt_moe", test_size=test_size)
    pw = tw.get_workload("gpt_moe", test_size=test_size)
    jcfg, tcfg = jw.model.cfg, pw.cfg
    for field in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                  "intermediate_size", "max_seq", "remat", "remat_attn",
                  "attn_impl", "xent_impl", "n_experts", "moe_every_k",
                  "capacity_factor", "router", "aux_loss_weight"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    assert pw.global_batch_size == jw.global_batch_size
    assert pw.seq_len == jw.init_batch["input_ids"].shape[1]
    assert pw.model_cls is tm.GPTMoELM


def test_train_torch_gpt_moe_matches_jax(capsys, monkeypatch):
    """``train_torch.py --workload gpt_moe --test-size --device cpu``
    prints three losses; the JAX step (``_step_body``, jitted, the
    preset's AdamW) from the same seeded weights on the same batches gives
    the same losses to 1e-5 relative.  Both presets run in fp32 here: in
    bf16 the two frameworks round the router's input at other places, and
    tokens whose top-2/top-3 router probabilities lie within ~1e-4 of a
    tie go to other experts, which moves the loss by ~4e-4."""
    monkeypatch.setattr(tw, "gpt_moe_tiny", lambda: dataclasses.replace(
        tm.gpt_moe_tiny(), dtype=torch.float32))
    monkeypatch.setattr(jax_gpt_moe, "gpt_moe_tiny", lambda: dataclasses.replace(
        jax_gpt_moe_tiny(), dtype=jnp.float32))
    records = train_torch.main(["--workload", "gpt_moe", "--test-size",
                                "--device", "cpu", "--steps", "3",
                                "--log-every", "1", "--seed", "0"])
    assert len(capsys.readouterr().out.strip().splitlines()) == 3
    pw = tw.get_workload("gpt_moe", test_size=True)
    jw = jax_workloads.get_workload("gpt_moe", test_size=True)
    params = jax.tree.map(jnp.asarray, tm.params_to_flax(
        pw.init_params(pw.cfg, torch.Generator().manual_seed(0)), pw.cfg))
    tx = jw.make_optimizer()
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          model_state={}, opt_state=tx.init(params), tx=tx)
    step = jax.jit(_step_body(jw.loss_fn, 1))
    source = jw.input_fn(JaxInputContext(global_batch_size=8), 0)
    for rec in records:
        state, m = step(state, {k: jnp.asarray(v)
                                for k, v in next(source).items()},
                        jax.random.PRNGKey(0))
        assert rec["step"] == int(state.step)
        np.testing.assert_allclose(rec["loss"], float(m["loss"]), rtol=1e-5)
