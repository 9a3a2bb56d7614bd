"""The port's training step against the JAX package's.

Both packages start from one seeded JAX init (moved across with
``params_from_flax``) and read identical ``synthetic_lm`` batches.  fp32
unless a test says otherwise; on the CPU the port takes its kernels' plain twins, the JAX
side its interpret-mode Pallas kernels (``attn_impl="pallas"``) or its
XLA path (the presets' ``"auto"``).  The JAX package is only called.
"""

import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import train_torch
from distributedtensorflow_tpu import workloads as jax_workloads
from distributedtensorflow_tpu.data.input_pipeline import (
    InputContext as JaxInputContext,
)
from distributedtensorflow_tpu.models import GPTLM as JaxGPTLM
from distributedtensorflow_tpu.models import gpt_tiny as jax_gpt_tiny
from distributedtensorflow_tpu.models import lm_loss as jax_lm_loss
from distributedtensorflow_tpu.ops.xent import (
    chunked_softmax_xent as jax_chunked_xent,
)
from distributedtensorflow_tpu.train import optimizers as jax_optimizers
from distributedtensorflow_tpu.train.engine import _step_body
from distributedtensorflow_tpu.train.state import TrainState as JaxTrainState
from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch import train as tt
from distributedtensorflow_tpu_torch import workloads as tw
from distributedtensorflow_tpu_torch.data import InputContext
from distributedtensorflow_tpu_torch.ops.xent import chunked_softmax_xent
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401


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


# ------------------------------------------------------------- the xent head


@pytest.mark.parametrize("chunk_tokens,logits", [(16, "fp32"), (4096, "fp32"),
                                                 (24, "bf16")])
def test_chunked_xent_matches_jax(chunk_tokens, logits):
    """Value and grads with masked positions and targets outside [0, V)
    (weight 0), over several chunks (the last one ragged) or one."""
    rng = np.random.default_rng(chunk_tokens)
    b, s, d, v = 3, 20, 16, 50
    hidden = rng.standard_normal((b, s, d)).astype(np.float32)
    wte = (0.3 * rng.standard_normal((v, d))).astype(np.float32)
    targets = rng.integers(0, v, (b, s))
    targets[0, :3] = [-100, v, v + 7]
    mask = (rng.random((b, s)) > 0.2).astype(np.float32)
    ldt = {"fp32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}[logits]

    def jf(h, w):
        return jax_chunked_xent(h, w, jnp.asarray(targets), jnp.asarray(mask),
                                chunk_tokens=chunk_tokens,
                                logits_dtype=ldt[0])

    jloss, (jdh, jdw) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(wte))
    h = torch.from_numpy(hidden).requires_grad_(True)
    w = torch.from_numpy(wte).requires_grad_(True)
    loss = chunked_softmax_xent(h, w, torch.from_numpy(targets),
                                torch.from_numpy(mask),
                                chunk_tokens=chunk_tokens,
                                logits_dtype=ldt[1])
    loss.backward()
    tol = 1e-5 if logits == "fp32" else 1e-3  # bf16 tiles: one rounding
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=tol)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(jdh), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(jdw), rtol=0,
                               atol=tol)


# ------------------------------------------------------------------ the model


def _jax_params(jcfg, seed=0, seq=64):
    return jax.jit(JaxGPTLM(jcfg).init)(
        jax.random.PRNGKey(seed), jnp.zeros((2, seq), jnp.int32))["params"]


def test_params_to_flax_round_trip():
    """flax tree -> port state -> flax tree is bit-identical; a wrong
    state is refused."""
    jcfg = jax_gpt_tiny()
    params = _jax_params(jcfg)
    state = tm.params_from_flax(params, tm.gpt_tiny())
    back = tm.params_to_flax(state, tm.gpt_tiny())
    ref = dict(_flat(params))
    got = dict(_flat(back))
    assert got.keys() == ref.keys()
    for path, arr in ref.items():
        assert got[path].dtype == np.float32
        np.testing.assert_array_equal(got[path], arr)
    with pytest.raises(ValueError, match="unexpected"):
        tm.params_to_flax({**state, "stray": torch.zeros(1)}, tm.gpt_tiny())
    del state["ln_f.bias"]
    with pytest.raises(ValueError, match="no ln_f.bias"):
        tm.params_to_flax(state, tm.gpt_tiny())


MODEL_VARIANTS = {
    "remat_off": dict(remat=False),
    "remat_on": dict(remat=True),
    "remat_attn_gqa_window": dict(remat=False, remat_attn=True,
                                  num_kv_heads=2, attn_window=24),
}


@pytest.mark.parametrize("variant", sorted(MODEL_VARIANTS))
def test_model_loss_and_grads_match_jax(variant):
    """gpt_tiny at fp32 with the flash kernels forced on both sides: the
    loss and every gradient leaf (mapped back with ``params_to_flax``)
    equal ``jax.value_and_grad`` of the JAX ``lm_loss`` to 1e-4 of each
    leaf's max-abs."""
    kw = dict(MODEL_VARIANTS[variant], attn_impl="pallas")
    jcfg = dataclasses.replace(jax_gpt_tiny(), dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(tm.gpt_tiny(), dtype=torch.float32, **kw)
    params = _jax_params(jcfg)
    ids = np.random.default_rng(1).integers(0, 512, (2, 64))
    mask = np.ones((2, 64), np.float32)
    mask[1, 50:] = 0
    batch = {"input_ids": jnp.asarray(ids), "mask": jnp.asarray(mask)}
    loss_fn = jax_lm_loss(JaxGPTLM(jcfg))

    @jax.jit
    def jax_vg(p):
        return jax.value_and_grad(
            lambda p: loss_fn(p, {}, batch, jax.random.PRNGKey(0))[0])(p)

    jloss, jgrads = jax_vg(params)
    model = tm.GPTLM(tcfg, device="cpu")
    model.load_state_dict(tm.params_from_flax(params, tcfg))
    loss, metrics = tm.lm_loss(model)(
        {"input_ids": torch.as_tensor(ids), "mask": torch.from_numpy(mask)})
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["perplexity"]),
                               float(np.exp(float(jloss))), rtol=1e-5)
    _assert_trees_close(tm.params_to_flax(dict(zip(names, grads)), tcfg),
                        jax.tree.map(np.asarray, jgrads), rel=1e-4)


def test_training_forward_logits_match_generate_prefill():
    """The cache-free forward gives the decode path's logits."""
    cfg = dataclasses.replace(tm.gpt_tiny(), dtype=torch.float32)
    model = tm.GPTLM(cfg, device="cpu")
    model.load_state_dict(tm.init_params(cfg, torch.Generator().manual_seed(2)))
    ids = torch.as_tensor(np.random.default_rng(2).integers(0, 512, (2, 16)))
    with torch.no_grad():
        full = model(ids)
        cached, _ = tm.prefill(model, ids, torch.arange(16).expand(2, 16))
    torch.testing.assert_close(full, cached, rtol=0, atol=1e-5)


def test_dropout_is_seeded_and_remat_consistent():
    """Dropout draws one seed per block from the step's generator, so the
    same seed gives the same loss and grads with and without block
    remat, and another seed another loss."""
    base = dataclasses.replace(tm.gpt_tiny(), dtype=torch.float32,
                               dropout_rate=0.2)
    state = tm.init_params(base, torch.Generator().manual_seed(3))
    ids = torch.as_tensor(np.random.default_rng(3).integers(0, 512, (2, 32)))
    out = []
    for remat, seed in ((False, 5), (True, 5), (False, 6)):
        model = tm.GPTLM(dataclasses.replace(base, remat=remat), device="cpu")
        model.load_state_dict(state)
        loss, _ = tm.lm_loss(model)({"input_ids": ids},
                                    torch.Generator().manual_seed(seed))
        out.append((loss, torch.autograd.grad(loss, list(model.parameters()))))
    (l0, g0), (l1, g1), (l2, _) = out
    assert torch.equal(l0, l1) and float(l0.detach()) != float(l2.detach())
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    evaluated = tm.lm_eval(model)({"input_ids": ids})["loss"]
    assert float(evaluated) != float(l2.detach())


def test_head_and_config_choices():
    """Every head builds on the CPU ("auto" is the chunked head there,
    "fused" its plain twins); an unknown head raises; the blockwise FFN
    runs and refuses a chunk that does not divide the sequence."""
    cfg = tm.gpt_tiny()
    model = tm.GPTLM(cfg, device="cpu")
    assert tm.lm_loss(model) is not None  # "auto" is the chunked head
    ids = torch.as_tensor(np.random.default_rng(0).integers(0, 512, (2, 16)))
    for impl in ("chunked", "chunked_bf16", "fused"):
        m = tm.GPTLM(dataclasses.replace(cfg, xent_impl=impl), device="cpu")
        assert torch.isfinite(tm.lm_eval(m)({"input_ids": ids})["loss"])
    with pytest.raises(ValueError, match="xent_impl"):
        tm.lm_eval(tm.GPTLM(dataclasses.replace(cfg, xent_impl="dense"),
                            device="cpu"))
    chunked = tm.GPTLM(dataclasses.replace(cfg, ffn_chunk_size=8),
                       device="cpu")
    assert torch.isfinite(tm.lm_eval(chunked)({"input_ids": ids})["loss"])
    with pytest.raises(ValueError, match="does not divide"):
        tm.lm_eval(tm.GPTLM(dataclasses.replace(cfg, ffn_chunk_size=6),
                            device="cpu"))({"input_ids": ids})


# ------------------------------------------------------- optimizer and step


def test_adamw_matches_optax():
    """``optax.adamw(3e-4, weight_decay=0.1)`` and the port's AdamW give
    the same parameters over one gradient sequence, to a few fp32 ulps of
    the parameters (1e-6, under 1% of one step's 3e-4 update): the two
    order the same arithmetic differently."""
    rng = np.random.default_rng(4)
    p0 = rng.standard_normal((5, 7)).astype(np.float32)
    grads = [rng.standard_normal((5, 7)).astype(np.float32) for _ in range(4)]
    tx = optax.adamw(3e-4, weight_decay=0.1)
    jp, js = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = tt.adamw([tp], 3e-4, weight_decay=0.1)
    for g in grads:
        upd, js = tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   rtol=0, atol=1e-6)
    # with the bias/norm decay mask: named parameters, and the 1-D ones
    # left undecayed, as optax.adamw(mask=...) does
    jparams = {"dense": {"kernel": jnp.asarray(p0),
                         "bias": jnp.asarray(p0[0])}}
    tx = optax.adamw(3e-4, weight_decay=0.1,
                     mask=jax_optimizers.exclude_bias_and_norm_mask)
    js = tx.init(jparams)
    named = [("dense.kernel", torch.nn.Parameter(torch.from_numpy(p0.copy()))),
             ("dense.bias", torch.nn.Parameter(torch.from_numpy(p0[0].copy())))]
    opt = tt.adamw(named, 3e-4, weight_decay=0.1,
                   mask=tt.exclude_bias_and_norm_mask)
    for g in grads:
        jg = {"dense": {"kernel": jnp.asarray(g), "bias": jnp.asarray(g[0])}}
        upd, js = tx.update(jg, js, jparams)
        jparams = optax.apply_updates(jparams, upd)
        named[0][1].grad = torch.from_numpy(g)
        named[1][1].grad = torch.from_numpy(g[0].copy())
        opt.step()
    for (_, p), ref in zip(named, (jparams["dense"]["kernel"],
                                   jparams["dense"]["bias"])):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref),
                                   rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="named parameters"):
        tt.adamw([tp], mask=tt.exclude_bias_and_norm_mask)


def test_synthetic_lm_matches_jax():
    jit_ = jax_workloads.synthetic_lm(
        JaxInputContext(global_batch_size=4, input_pipeline_id=1),
        vocab_size=97, seq_len=12, seed=3)
    tit = tw.synthetic_lm(InputContext(global_batch_size=4,
                                       input_pipeline_id=1),
                          vocab_size=97, seq_len=12, seed=3)
    for _ in range(3):
        a, b = next(jit_), next(tit)
        assert a.keys() == b.keys()
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
        assert b["input_ids"].dtype == np.int32


WORKLOAD_CASES = {
    "gpt_lm": ("gpt_lm", {}),
    "gpt_medium_lm": ("gpt_medium_lm", {}),
    "test_size_overrides": ("gpt_lm", dict(
        test_size=True, seq_len=512, remat="attn", attn_impl="pallas",
        xent_impl="chunked", kv_heads=2, attn_window=64,
        global_batch_size=4)),
    "lm_long_context": ("lm_long_context", {}),
    "lm_long_context_overrides": ("lm_long_context", dict(
        seq_len=4096, remat="on", attn_impl="auto", xent_impl="fused")),
    "lm_long_context_test_size": ("lm_long_context", dict(test_size=True)),
}


@pytest.mark.parametrize("case", sorted(WORKLOAD_CASES))
def test_get_workload_matches_jax(case):
    name, kw = WORKLOAD_CASES[case]
    jw = jax_workloads.get_workload(name, **kw)
    pw = tw.get_workload(name, **kw)
    jcfg, tcfg = jw.model.cfg, pw.cfg
    for field in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                  "intermediate_size", "max_seq", "remat", "remat_attn",
                  "attn_impl", "xent_impl", "num_kv_heads", "attn_window",
                  "dropout_rate", "ffn_chunk_size"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    assert pw.global_batch_size == jw.global_batch_size
    assert pw.seq_len == jw.init_batch["input_ids"].shape[1]
    _check_bert_moe_preset(test_size=case.endswith("test_size"))


def _check_bert_moe_preset(test_size):
    """The port's ``bert_moe`` preset field by field against JAX's: the
    model config, seq, global batch, accumulation, the first input batch,
    and one update of its optimizer (AdamW 1e-4, decay 0.01) against
    optax's."""
    jw = jax_workloads.get_workload("bert_moe", test_size=test_size)
    pw = tw.get_workload("bert_moe", test_size=test_size)
    jcfg, tcfg = jw.model.cfg, pw.cfg
    for field in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                  "intermediate_size", "max_position", "dropout_rate",
                  "n_experts", "capacity_factor", "router", "moe_every"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    assert str(tcfg.dtype).removeprefix("torch.") == jnp.dtype(
        jcfg.dtype).name
    assert pw.global_batch_size == jw.global_batch_size == 256
    assert pw.accum_steps == jw.accum_steps == 4
    assert pw.seq_len == jw.init_batch["input_ids"].shape[1]
    assert pw.model_takes_group
    jb = next(jw.input_fn(JaxInputContext(global_batch_size=2), 5))
    tb = next(pw.input_fn(InputContext(global_batch_size=2), 5))
    assert jb.keys() == tb.keys()
    for k in jb:
        np.testing.assert_array_equal(jb[k], tb[k])
    w = np.linspace(-1.0, 1.0, 12, dtype=np.float32).reshape(3, 4)
    g = np.cos(w * 7.0)
    tx = jw.make_optimizer()
    upd, _ = tx.update(jnp.asarray(g), tx.init(jnp.asarray(w)),
                       jnp.asarray(w))
    p = torch.nn.Parameter(torch.tensor(w))
    opt = pw.make_optimizer([("w", p)])
    p.grad = torch.tensor(g)
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), w + np.asarray(upd),
                               rtol=0, atol=1e-7)


def test_default_workload_is_train_py_s():
    """``train_torch.py`` without ``--workload`` trains train.py's default
    preset (read from train.py's source, which is not imported)."""
    import re
    from pathlib import Path

    src = (Path(train_torch.__file__).parent / "train.py").read_text()
    default = re.search(r'add_argument\(\s*"--workload",\s*default="(\w+)"',
                        src).group(1)
    assert default == "mnist_lenet"
    assert train_torch.parse_args([]).workload == default


#: (dtype, accum_steps, relative tolerance of the losses).  fp32 isolates
#: the algorithm; bf16 is the preset's own dtype, where the two
#: frameworks round at other places (per op in torch, per fusion in XLA)
#: and the first loss already differs by ~6e-5.
STEP_CASES = {"fp32_accum1": (jnp.float32, torch.float32, 1, 1e-5),
              "fp32_accum2": (jnp.float32, torch.float32, 2, 1e-5),
              "bf16_accum1": (jnp.bfloat16, torch.bfloat16, 1, 2e-4)}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_steps_match_jax(case):
    """Three steps of the port's ``make_train_step`` against the JAX
    ``_step_body`` jitted on the CPU, the ``gpt_lm`` test-size preset
    with AdamW(3e-4, weight decay 0.1), from one init, on the same
    ``synthetic_lm`` batches: the three losses (and perplexities, their
    exponentials) agree to the case's relative tolerance."""
    jdt, tdt, accum_steps, tol = STEP_CASES[case]
    jw = jax_workloads.get_workload("gpt_lm", test_size=True)
    pw = tw.get_workload("gpt_lm", test_size=True)
    jcfg = dataclasses.replace(jw.model.cfg, dtype=jdt)
    tcfg = dataclasses.replace(pw.cfg, dtype=tdt)
    params = _jax_params(jcfg)
    tx = jw.make_optimizer()
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           model_state={}, opt_state=tx.init(params), tx=tx)
    jstep = jax.jit(_step_body(jax_lm_loss(JaxGPTLM(jcfg)), accum_steps))
    model = tm.GPTLM(tcfg, device="cpu")
    model.load_state_dict(tm.params_from_flax(params, tcfg))
    state = tt.TrainState(0, model, pw.make_optimizer(model.parameters()))
    step = tt.make_train_step(tm.lm_loss(model), accum_steps=accum_steps)
    jsrc = jw.input_fn(JaxInputContext(global_batch_size=8), 0)
    tsrc = pw.input_fn(InputContext(global_batch_size=8), 0)
    for i in range(3):
        jb, tb = next(jsrc), next(tsrc)
        np.testing.assert_array_equal(jb["input_ids"], tb["input_ids"])
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in jb.items()},
                           jax.random.PRNGKey(0))
        state, m = step(state, {k: torch.as_tensor(v, dtype=torch.long)
                                for k, v in tb.items()})
        assert state.step == int(jstate.step) == i + 1
        loss, jloss = float(m["loss"]), float(jm["loss"])
        np.testing.assert_allclose(loss, jloss, rtol=tol)
        # exp turns an absolute loss difference into a relative one
        np.testing.assert_allclose(float(m["perplexity"]),
                                   float(jm["perplexity"]),
                                   rtol=2 * tol * abs(jloss))


def test_eval_step_and_step_generator():
    cfg = tm.gpt_tiny()
    model = tm.GPTLM(cfg, device="cpu")
    state = tt.TrainState(0, model, tt.adamw(model.parameters()))
    batch = {"input_ids": torch.as_tensor(
        np.random.default_rng(5).integers(0, 512, (2, 16)))}
    got = tt.make_eval_step(tm.lm_eval(model))(state, batch)
    assert torch.equal(got["loss"], tm.lm_eval(model)(batch)["loss"])
    draws = [int(torch.randint(2**30, (), generator=tt.step_generator(0, s, m)))
             for s, m in ((0, 0), (0, 0), (1, 0), (0, 1))]
    assert draws[0] == draws[1] and len(set(draws)) == 3
    with pytest.raises(ValueError, match="accum_steps"):
        tt.split_microbatches(batch, 3)


def test_train_torch_runs_in_process(capsys):
    """``train_torch.py --workload gpt_lm --test-size --device cpu
    --steps 3`` trains and prints one JSON line per step."""
    records = train_torch.main(["--workload", "gpt_lm", "--test-size",
                                "--device", "cpu", "--steps", "3",
                                "--log-every", "1"])
    assert [r["step"] for r in records] == [1, 2, 3]
    for r in records:
        assert np.isfinite(r["loss"]) and r["step_ms"] > 0
        assert set(r) == {"step", "loss", "perplexity", "step_ms",
                          "examples_per_sec", "tokens_per_sec"}
    assert len(capsys.readouterr().out.strip().splitlines()) == 3


# ------------------------------------------------- blockwise FFN, optimizers


def test_ffn_chunk_size_matches_jax():
    """gpt_tiny at fp32 with the blockwise FFN (chunks of 16 of 64 tokens,
    each recomputed in the backward) against JAX's: the loss and every
    gradient leaf to 1e-4 of its max-abs; a chunk that does not divide
    the sequence raises in both."""
    jcfg = dataclasses.replace(jax_gpt_tiny(), dtype=jnp.float32,
                               ffn_chunk_size=16)
    tcfg = dataclasses.replace(tm.gpt_tiny(), dtype=torch.float32,
                               ffn_chunk_size=16)
    params = _jax_params(jcfg)
    ids = np.random.default_rng(8).integers(0, 512, (2, 64))
    loss_fn = jax_lm_loss(JaxGPTLM(jcfg))
    jloss, jgrads = jax.value_and_grad(lambda p: loss_fn(
        p, {}, {"input_ids": jnp.asarray(ids)}, jax.random.PRNGKey(0))[0])(
            params)
    model = tm.GPTLM(tcfg, device="cpu")
    model.load_state_dict(tm.params_from_flax(params, tcfg))
    loss, _ = tm.lm_loss(model)({"input_ids": torch.as_tensor(ids)})
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    _assert_trees_close(tm.params_to_flax(dict(zip(names, grads)), tcfg),
                        jax.tree.map(np.asarray, jgrads), rel=1e-4)
    bad = dataclasses.replace(jcfg, ffn_chunk_size=24)
    with pytest.raises(ValueError, match="does not divide"):
        JaxGPTLM(bad).apply({"params": params}, jnp.asarray(ids),
                            return_hidden=True)
    model = tm.GPTLM(dataclasses.replace(tcfg, ffn_chunk_size=24),
                     device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        model(torch.as_tensor(ids), return_hidden=True)


def test_blockwise_map_matches_the_whole_sequence():
    from distributedtensorflow_tpu_torch.ops.blockwise import blockwise_map

    x = torch.randn(2, 12, 5, requires_grad=True)
    lin = torch.nn.Linear(5, 7)

    def fn(h):
        return torch.tanh(lin(h))

    got = blockwise_map(fn, x, 4)
    torch.testing.assert_close(got, fn(x))
    g1 = torch.autograd.grad(got.sum(), (x, lin.weight))
    g2 = torch.autograd.grad(fn(x).sum(), (x, lin.weight))
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b)
    with pytest.raises(ValueError, match="not divisible"):
        blockwise_map(fn, x, 5)
    with pytest.raises(ValueError, match="positive"):
        blockwise_map(fn, x, 0)


SCHEDULE_CASES = [("constant", 0), ("constant", 2), ("cosine", 0),
                  ("cosine", 2), ("linear", 0), ("linear", 2)]


@pytest.mark.parametrize("name,warmup", SCHEDULE_CASES)
def test_build_schedule_matches_optax(name, warmup):
    """The learning rate at optax's counts 0..7 (past the end too)."""
    j = jax_optimizers.build_schedule(name, 0.1, warmup_steps=warmup,
                                      total_steps=5)
    t = tt.build_schedule(name, 0.1, warmup_steps=warmup, total_steps=5)
    for count in range(8):
        want = float(j(count)) if callable(j) else j
        got = t(count) if callable(t) else t
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


def test_build_schedule_validation():
    for name, kw, match in (("cosine", {}, "total_steps"),
                            ("linear", dict(warmup_steps=5, total_steps=5),
                             "warmup_steps"),
                            ("step", {}, "schedule must be")):
        with pytest.raises(ValueError, match=match):
            tt.build_schedule(name, 0.1, **kw)


#: optimizer, schedule, warmup, weight decay, clipnorm, decay mask
OPT_CASES = {
    "sgd": ("sgd", "constant", 0, 0.0, 0.0, False),
    "momentum_cosine": ("momentum", "cosine", 1, 0.0, 0.0, False),
    "adam_linear_clip": ("adam", "linear", 1, 0.0, 1.0, False),
    "adamw_cosine_clip_mask": ("adamw", "cosine", 0, 0.1, 0.5, True),
    "adamw_linear": ("adamw", "linear", 2, 0.1, 0.0, False),
    "adagrad_warmup": ("adagrad", "constant", 2, 0.0, 0.0, False),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_build_optimizer_matches_optax(case):
    """``build_optimizer`` against the JAX package's optax chain over
    three updates from the same gradients, on a tree with a matrix, a
    bias, a norm scale and an embedding: every parameter to 1e-6 (a few
    fp32 ulps; the two order the same arithmetic differently)."""
    name, sched, warmup, wd, clip, masked = OPT_CASES[case]
    rng = np.random.default_rng(9)
    shapes = {("dense", "kernel"): (5, 7), ("dense", "bias"): (7,),
              ("ln", "scale"): (7,), ("emb", "embedding"): (3, 7)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]

    def tree(flat):
        out = {}
        for (a, b), v in flat.items():
            out.setdefault(a, {})[b] = jnp.asarray(v)
        return out

    jlr = jax_optimizers.build_schedule(sched, 0.05, warmup_steps=warmup,
                                        total_steps=4)
    tx = jax_optimizers.build_optimizer(
        name, jlr, weight_decay=wd, global_clipnorm=clip,
        decay_mask=(jax_optimizers.exclude_bias_and_norm_mask
                    if masked else None))
    jp = tree(p0)
    js = tx.init(jp)
    named = [(".".join(k), torch.nn.Parameter(torch.from_numpy(v.copy())))
             for k, v in p0.items()]
    tlr = tt.build_schedule(sched, 0.05, warmup_steps=warmup, total_steps=4)
    opt = tt.build_optimizer(
        name, tlr, weight_decay=wd, global_clipnorm=clip,
        decay_mask=tt.exclude_bias_and_norm_mask if masked else None)(named)
    for g in grads:
        upd, js = tx.update(tree(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        for (key, _), (_, p) in zip(p0.items(), named):
            p.grad = torch.from_numpy(g[key])
        opt.step()
        for (key, _), (_, p) in zip(p0.items(), named):
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jp[key[0]][key[1]]),
                                       rtol=0, atol=1e-6, err_msg=str(key))


@pytest.mark.parametrize("name", ["sgd", "momentum", "adamw", "adagrad"])
def test_restored_optimizer_continues_the_schedule(name):
    """Warm-up plus cosine over three updates, then the optimizer's
    ``state_dict`` loaded into a fresh optimizer over a copy of the
    parameters: its next learning rate and update equal those of the run
    that was not interrupted (the schedule's count travels in the state,
    so warm-up does not restart)."""
    rng = np.random.default_rng(11)
    p0 = {"w": rng.standard_normal((4, 3)).astype(np.float32),
          "b": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(4)]
    lr = tt.build_schedule("cosine", 0.1, warmup_steps=2, total_steps=6)
    make = tt.build_optimizer(name, lr, global_clipnorm=1.0,
                              weight_decay=0.01 if name == "adamw" else 0.0)

    def params():
        return [(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
                for k, v in p0.items()]

    def step(opt, named, g):
        for k, p in named:
            p.grad = torch.from_numpy(g[k].copy())  # clipping is in place
        opt.step()

    whole = params()
    opt = make(whole)
    for g in grads[:3]:
        step(opt, whole, g)
    buf = io.BytesIO()  # as a checkpoint file holds it
    torch.save(opt.state_dict(), buf)
    buf.seek(0)
    saved = torch.load(buf)
    resumed = [(k, torch.nn.Parameter(p.detach().clone())) for k, p in whole]
    opt2 = make(resumed)
    opt2.load_state_dict(saved)
    step(opt, whole, grads[3])
    step(opt2, resumed, grads[3])
    assert opt2.param_groups[0]["lr"] == opt.param_groups[0]["lr"] == lr(3)
    assert opt.param_groups[0]["count"] == opt2.param_groups[0]["count"] == 4
    for (_, a), (_, b) in zip(whole, resumed):
        assert torch.equal(a, b)
    # a fresh optimizer without the state starts warm-up again
    opt3 = make([(k, torch.nn.Parameter(p.detach().clone()))
                 for k, p in whole])
    opt3.zero_grad()
    for group in opt3.param_groups:
        for p in group["params"]:
            p.grad = torch.zeros_like(p)
    opt3.step()
    assert opt3.param_groups[0]["lr"] == lr(0) != lr(3)


def test_build_optimizer_validation_and_queued_optimizers():
    with pytest.raises(ValueError, match="no decoupled weight decay"):
        tt.build_optimizer("adam", 0.1, weight_decay=0.1)
    with pytest.raises(ValueError, match="global_clipnorm"):
        tt.build_optimizer("sgd", 0.1, global_clipnorm=-1.0)
    with pytest.raises(ValueError, match="decay_mask"):
        tt.build_optimizer("sgd", 0.1,
                           decay_mask=tt.exclude_bias_and_norm_mask)
    for name in ("lamb", "lars", "adafactor", "lion"):
        # each builds and steps (tests/test_torch_optimizers2.py holds them
        # to optax)
        p = torch.nn.Parameter(torch.ones(3, 4))
        opt = tt.build_optimizer(name, 0.1)([("w", p)])
        p.grad = torch.full_like(p, 0.5)
        opt.step()
        assert opt.param_groups[0]["count"] == 1
        assert torch.isfinite(p).all() and not torch.equal(
            p, torch.ones(3, 4))
    with pytest.raises(ValueError, match="optimizer must be one of"):
        tt.build_optimizer("rmsprop", 0.1)
    model = tm.GPTLM(tm.gpt_tiny(), device="cpu")
    mask = tt.exclude_bias_and_norm_mask(model.named_parameters())
    assert mask["wte.weight"] and mask["h.0.attn.qkv.weight"]
    assert not mask["h.0.ln1.scale"] and not mask["ln_f.bias"]


def test_train_torch_logdir_passes_the_metrics_schema(tmp_path, capsys):
    """``--logdir`` writes ``metrics.jsonl`` rows with the keys of
    train.py's Trainer (with an eval row and an optimizer override), and
    ``tools/check_metrics_schema`` finds no error in them; the override
    flags refuse what train.py refuses."""
    from tools import check_metrics_schema

    logdir = tmp_path / "run"
    train_torch.main(["--workload", "gpt_lm", "--test-size", "--device",
                      "cpu", "--steps", "2", "--log-every", "1",
                      "--eval-every", "2", "--logdir", str(logdir),
                      "--optimizer", "adamw", "--lr", "1e-3", "--schedule",
                      "cosine", "--warmup-steps", "1", "--weight-decay",
                      "0.1", "--decay-mask", "bias-norm", "--clipnorm",
                      "1.0"])
    path = logdir / "metrics.jsonl"
    errors, _ = check_metrics_schema.check_file(str(path))
    assert errors == []
    rows = [json.loads(x) for x in path.read_text().splitlines()]
    train_keys = {
        "step", "loss", "perplexity", "steps_per_sec", "examples_per_sec",
        "examples_per_sec_per_chip", "t_step", "t_data", "t_dispatch",
        "t_host", "f_data", "f_dispatch", "f_host", "host_rss_gib",
        "live_arrays", "live_arrays_gib", "params_bytes_per_device",
        "opt_state_bytes_per_device", "engine_dispatches_total.kind_train_step"}
    assert [train_keys <= set(r) for r in rows[:2]] == [True, True]
    assert set(rows[2]) == {"step", "eval_loss", "eval_perplexity"}
    assert [r["step"] for r in rows] == [1, 2, 2]
    capsys.readouterr()
    for argv, match in ((["--lr", "0.1"], "--lr requires --optimizer"),
                        (["--optimizer", "sgd"], "--optimizer requires --lr"),
                        (["--optimizer", "sgd", "--lr", "0.1",
                          "--weight-decay", "0.1"], "no decoupled"),
                        (["--optimizer", "adafactor", "--lr", "0.1",
                          "--weight-decay", "0.1"], "no decoupled"),
                        (["--schedule", "cosine"], "require --optimizer")):
        with pytest.raises(SystemExit, match=match):
            train_torch.main(["--test-size", "--device", "cpu", "--steps",
                              "1", *argv])
