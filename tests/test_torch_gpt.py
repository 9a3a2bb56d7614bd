"""The port's decode-mode GPT and generation against the JAX package's.

Both packages run ``gpt_tiny`` from the same weights: the JAX tree from
``GPTLM.init``, converted by ``params_from_flax``.  fp32 throughout
unless a test says otherwise; on the CPU the port takes its kernels'
plain twins, the JAX side its interpret-mode kernels.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtensorflow_tpu.models import GPTLM as JaxGPTLM
from distributedtensorflow_tpu.models import generate as jax_generate
from distributedtensorflow_tpu.models import gpt_tiny as jax_gpt_tiny
from distributedtensorflow_tpu.models import prefill as jax_prefill
from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401

VARIANTS = {
    "mha": {},
    "gqa": {"num_kv_heads": 2},
    "gqa_window": {"num_kv_heads": 2, "attn_window": 5},
}


def _pair(variant="mha", dtype="fp32", max_seq=64, seed=0):
    """(jax cfg, jax params, port model, jitted jax prefill) from one
    seeded JAX init (jitted: eager flax and interpret-mode kernels
    dispatch op by op, which is slower than one compile)."""
    kw = dict(VARIANTS[variant], max_seq=max_seq)
    jcfg = dataclasses.replace(
        jax_gpt_tiny(), dtype={"fp32": jnp.float32, "bf16": jnp.bfloat16}[dtype],
        **kw)
    tcfg = dataclasses.replace(
        tm.gpt_tiny(),
        dtype={"fp32": torch.float32, "bf16": torch.bfloat16}[dtype], **kw)
    params = jax.jit(JaxGPTLM(jcfg).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    model = tm.GPTLM(tcfg, device="cpu")
    model.load_state_dict(tm.params_from_flax(params, tcfg))
    return jcfg, params, model, jax.jit(functools.partial(jax_prefill,
                                                          cfg=jcfg))


@pytest.fixture(scope="module")
def mha():
    return _pair("mha")


@pytest.fixture(scope="module")
def gqa():
    return _pair("gqa")


def _ids(b, s, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def test_params_from_flax_round_trip(mha):
    """Every flax leaf lands in the port's state (Dense kernels
    transposed to (out, in)) and maps back exactly; a wrong tree is
    refused."""
    _, params, model, _ = mha
    state = model.state_dict()
    flat = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat[path + (k,)] = np.asarray(v)

    walk(params, ())
    assert len(flat) == len(state)
    for path, arr in flat.items():
        if path == ("wte", "embedding"):
            name = "wte.weight"
        else:
            parts = [f"h.{path[0][1:]}" if path[0][0] == "h" and
                     path[0][1:].isdigit() else path[0], *path[1:]]
            name = ".".join(parts)
            if name.endswith(".kernel"):
                name = name[: -len("kernel")] + "weight"
        back = state[name].numpy()
        if path[-1] == "kernel":
            back = back.T
        np.testing.assert_array_equal(back, arr)
    cfg = model.cfg
    extra = {**params, "stray": {"kernel": np.zeros(2)}}
    with pytest.raises(ValueError, match="unexpected"):
        tm.params_from_flax(extra, cfg)
    missing = {k: v for k, v in params.items() if k != "ln_f"}
    with pytest.raises(ValueError, match="no ln_f"):
        tm.params_from_flax(missing, cfg)


@pytest.mark.parametrize("variant", ["mha", "gqa"])
def test_prefill_logits_and_cache_match(variant, mha, gqa):
    jcfg, params, model, jprefill = {"mha": mha, "gqa": gqa}[variant]
    ids = _ids(2, 8)
    pos = np.tile(np.arange(8), (2, 1))
    j_logits, j_cache = jprefill(params, jnp.asarray(ids), jnp.asarray(pos))
    t_logits, t_cache = tm.prefill(model, torch.as_tensor(ids),
                                   torch.as_tensor(pos))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=1e-4, atol=1e-4)
    for i in range(jcfg.num_layers):
        j_layer = j_cache[f"h{i}"]["attn"]
        t_layer = t_cache[f"h{i}"]["attn"]
        assert t_layer["cache_index"] == int(j_layer["cache_index"]) == 8
        np.testing.assert_allclose(t_layer["cached_key"].numpy(),
                                   np.asarray(j_layer["cached_key"]),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant", ["mha", "gqa"])
def test_chunked_prefill_then_decode_steps_match(variant, mha, gqa):
    """Two 4-token chunks then three single-token steps (the kernel
    path on the card) give the JAX logits at every call."""
    jcfg, params, model, jprefill = {"mha": mha, "gqa": gqa}[variant]
    ids = _ids(2, 11, seed=1)
    j_cache = t_cache = None
    for start, width in ((0, 4), (4, 4), (8, 1), (9, 1), (10, 1)):
        tok = ids[:, start:start + width]
        pos = np.tile(np.arange(start, start + width), (2, 1))
        j_logits, j_cache = jprefill(params, jnp.asarray(tok),
                                     jnp.asarray(pos), cache=j_cache)
        t_logits, t_cache = tm.prefill(model, torch.as_tensor(tok),
                                       torch.as_tensor(pos), cache=t_cache)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant,eos", [("mha", True), ("gqa", False),
                                         ("gqa_window", False)])
def test_greedy_generate_tokens_identical(variant, eos, mha, gqa):
    """Greedy tokens equal JAX's with ragged prompts (and, for one
    variant, eos freezing); the window variant masks the cache in the
    single-token steps."""
    jcfg, params, model, _ = {"mha": mha, "gqa": gqa}.get(variant) or \
        _pair(variant)
    ids = _ids(2, 8, seed=2)
    lens = np.array([8, 5])
    eos_id = None
    if eos:  # a token that row 0 emits early
        eos_id = int(tm.generate(model, ids[:1], max_new_tokens=3)[0, 9])
    j = np.asarray(jax_generate(params, jnp.asarray(ids), cfg=jcfg,
                                max_new_tokens=10,
                                prompt_lens=jnp.asarray(lens),
                                eos_token_id=eos_id))
    t = tm.generate(model, ids, max_new_tokens=10, prompt_lens=lens,
                    eos_token_id=eos_id).numpy()
    np.testing.assert_array_equal(t, j)
    if eos:
        assert (t[0, 9:] == eos_id).all()


def test_bf16_first_step_logits():
    """At the production dtype the two frameworks round at different
    places (per op in torch, per fusion in XLA), so first-step logits
    agree to bf16 precision and tokens are not compared: near-ties may
    flip."""
    jcfg, params, model, jprefill = _pair("mha", dtype="bf16")
    ids = _ids(2, 8, seed=3)
    pos = np.tile(np.arange(8), (2, 1))
    j_logits, _ = jprefill(params, jnp.asarray(ids), jnp.asarray(pos))
    t_logits, _ = tm.prefill(model, torch.as_tensor(ids),
                             torch.as_tensor(pos))
    assert t_logits.dtype == torch.float32
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=0, atol=5e-2)


def test_sampled_generate_is_seeded(mha):
    """Temperature / top-k / top-p sampling draws from the caller's
    generator: the same seed gives the same tokens, inside the vocab."""
    _, _, model, _ = mha
    ids = _ids(2, 4, seed=4)

    def run(seed):
        return tm.generate(model, ids, max_new_tokens=8, temperature=0.9,
                           top_k=20, top_p=0.9,
                           generator=torch.Generator().manual_seed(seed))

    a, b = run(5), run(5)
    assert torch.equal(a, b)
    assert a.shape == (2, 12) and int(a.min()) >= 0 and int(a.max()) < 512
    assert torch.equal(a[:, :4], torch.as_tensor(ids))


def test_generate_validation(mha):
    _, _, model, _ = mha
    with pytest.raises(ValueError, match="top_p"):
        tm.generate(model, _ids(1, 4), max_new_tokens=2, top_p=0.0)
    with pytest.raises(ValueError, match="max_seq"):
        tm.generate(model, _ids(1, 60), max_new_tokens=10)


def test_training_forward_and_quant_are_not_ported(mha):
    """The training forward is ported now (no cache: the JAX model's
    full forward, fp32 logits), and so is the fused loss head (K4f/K4b,
    its plain twins on the CPU), and so are the quantised dense layers
    (``tests/test_torch_quant.py``); an unknown mode raises."""
    jcfg, params, model, _ = mha
    ids = _ids(2, 8, seed=6)
    ref = JaxGPTLM(jcfg).apply({"params": params}, jnp.asarray(ids))
    got = model(torch.as_tensor(ids))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)
    cfg = dataclasses.replace(tm.gpt_tiny(), quant="int4")
    with pytest.raises(ValueError, match="quant mode"):
        tm.GPTLM(cfg, device="cpu")
    cfg = dataclasses.replace(tm.gpt_tiny(), quant="int8")
    assert type(tm.GPTLM(cfg, device="cpu").h[0].fc_in).__name__ \
        == "QuantDense"
    cfg = dataclasses.replace(tm.gpt_tiny(), xent_impl="fused")
    fused = tm.GPTLM(cfg, device="cpu")
    loss, _ = tm.lm_loss(fused)({"input_ids": torch.as_tensor(ids)})
    assert torch.isfinite(loss)
