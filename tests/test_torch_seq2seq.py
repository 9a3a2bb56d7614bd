"""The port's seq2seq encoder-decoder and its ``t5_seq2seq`` preset
against the JAX package's, and the ops it brings: the tied chunked argmax
and RMSNorm.

Both packages run ``seq2seq_tiny`` (2+2 layers, hidden 128, vocab 512)
from one flax ``init`` moved across with ``params_from_flax``, with
multi-head attention and with two K/V heads (GQA), on numpy-seeded ids
with pad tails in the encoder input and the targets, in fp32 at dropout
0; on the CPU the port's decode attention takes the kernel's plain twin
and JAX's its plain path.  Tolerances: encoder outputs and decoder
states within 1e-5 of their max-abs, losses and metrics 1e-5 relative,
each gradient leaf within 1e-4 of its max-abs (as
``tests/test_torch_models.py``), RMSNorm 1e-6; argmax ids and greedy
tokens exactly; the bf16 loss within 1e-2 relative (the two frameworks
round at other places).  The JAX package is only called.
"""

import dataclasses

import flax.linen as flax_nn
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
from distributedtensorflow_tpu.models import seq2seq as jax_s2s
from distributedtensorflow_tpu.ops import xent as jax_xent
from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch import workloads as tw
from distributedtensorflow_tpu_torch.data import InputContext
from distributedtensorflow_tpu_torch.models.layers import DropoutKey, RMSNorm
from distributedtensorflow_tpu_torch.ops import xent as txent
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401

STATE_TOL = 1e-5
RTOL = 1e-5
GRAD_TOL = 1e-4
BF16_RTOL = 1e-2
PAD = 1
VARIANTS = {"mha": {}, "gqa": {"num_kv_heads": 2}}


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


def _close(got, ref, rel=STATE_TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def _pair(variant="mha", dtype="fp32", seed=0):
    """(jax cfg, jax variables, port model) of seq2seq_tiny from one
    init."""
    kw = VARIANTS[variant]
    jcfg = dataclasses.replace(
        jax_s2s.seq2seq_tiny(),
        dtype={"fp32": jnp.float32, "bf16": jnp.bfloat16}[dtype], **kw)
    tcfg = dataclasses.replace(
        tm.seq2seq_tiny(),
        dtype={"fp32": torch.float32, "bf16": torch.bfloat16}[dtype], **kw)
    z = jnp.zeros((2, 16), jnp.int32)
    variables = jax.device_get(jax.jit(jax_s2s.Seq2SeqLM(jcfg).init)(
        jax.random.PRNGKey(seed), z, z))
    model = tm.Seq2SeqLM(tcfg, device="cpu")
    model.load_state_dict(tm.params_from_flax(variables, tcfg))
    return jcfg, variables, model


@pytest.fixture(scope="module")
def mha():
    return _pair("mha")


@pytest.fixture(scope="module")
def gqa():
    return _pair("gqa")


def _pick(variant, mha, gqa):
    return {"mha": mha, "gqa": gqa}[variant]


def _batch(b=3, s_enc=16, s_dec=12, seed=0, vocab=512):
    """Ids in [2, vocab) with pad tails: encoder rows of 16, 11 and 6
    real tokens; target rows of 12, 7 and 9."""
    rng = np.random.default_rng(seed)
    enc = rng.integers(2, vocab, (b, s_enc))
    tgt = rng.integers(2, vocab, (b, s_dec))
    for i, (ne, nt) in enumerate(((16, 12), (11, 7), (6, 9))[:b]):
        enc[i, ne:] = PAD
        tgt[i, nt:] = PAD
    return {"encoder_ids": enc.astype(np.int32),
            "targets": tgt.astype(np.int32)}


def _torch(batch):
    return {k: torch.as_tensor(v, dtype=torch.long) for k, v in
            batch.items()}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_params_round_trip_and_names(variant, mha, gqa):
    """``params_to_flax(params_from_flax(x)) == x``, the names are the flax
    paths (``DenseGeneral`` kernels (E, H, D), (E, Hkv, D), (H, D, E)),
    and ``init_params`` gives every name."""
    _, variables, model = _pick(variant, mha, gqa)
    cfg = model.cfg
    back = tm.params_to_flax(tm.params_from_flax(variables, cfg), cfg)
    got, ref = dict(_flat(back)), dict(_flat(variables))
    assert got.keys() == ref.keys()
    for path in ref:
        np.testing.assert_array_equal(got[path], ref[path])
    kv = 2 if variant == "gqa" else 4
    p = variables["params"]
    assert p["dec_1"]["cross_attention"]["key"]["kernel"].shape == (128, kv,
                                                                    32)
    assert p["enc_0"]["attention"]["out"]["kernel"].shape == (4, 32, 128)
    init = tm.init_params(cfg, torch.Generator().manual_seed(0))
    assert init.keys() == model.state_dict().keys()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_encode_and_decode_match_jax(variant, mha, gqa):
    """``encode``'s outputs (pad rows included), pad mask and positions,
    and the decoder's final states on the shifted targets."""
    jcfg, variables, model = _pick(variant, mha, gqa)
    jm = jax_s2s.Seq2SeqLM(jcfg)
    batch = _batch()
    dec_in = np.asarray(jax_s2s.shift_right(jnp.asarray(batch["targets"]),
                                            jcfg.bos_id))
    j_enc, j_pad, j_pos = jax.jit(lambda p, e: jm.apply(
        {"params": p}, e, method=jm.encode))(variables["params"],
                                             batch["encoder_ids"])
    j_dec = jax.jit(lambda p, d, o, m, q: jm.apply(
        {"params": p}, d, o, m, q, method=jm.decode))(
        variables["params"], dec_in, j_enc, j_pad, j_pos)
    t = _torch(batch)
    with torch.no_grad():
        enc, pad, pos = model.encode(t["encoder_ids"])
        shifted = tm.shift_right(t["targets"], model.cfg.bos_id)
        dec = model.decode(shifted, enc, pad, pos)
    np.testing.assert_array_equal(shifted.numpy(), dec_in)
    _close(enc, j_enc)
    np.testing.assert_array_equal(pad.numpy(), np.asarray(j_pad))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(j_pos))
    _close(dec, j_dec)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_grads_match_jax(variant, mha, gqa):
    """``seq2seq_loss``: the mean NLL over non-pad targets, its perplexity
    and every parameter's gradient (the shared table's from the input
    embeddings of both streams and from the tied head)."""
    jcfg, variables, model = _pick(variant, mha, gqa)
    batch = _batch(seed=1)
    jloss = jax_s2s.seq2seq_loss(jax_s2s.Seq2SeqLM(jcfg))
    (jl, (jm, _)), jg = jax.jit(jax.value_and_grad(
        lambda p: jloss(p, {}, batch, jax.random.PRNGKey(0)),
        has_aux=True))(variables["params"])
    loss, metrics = tm.seq2seq_loss(model)(_torch(batch))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=RTOL)
    np.testing.assert_allclose(float(metrics["perplexity"]),
                               float(jm["perplexity"]), rtol=RTOL)
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    _assert_trees_close(tm.params_to_flax(grads, model.cfg)["params"],
                        jax.device_get(jg), GRAD_TOL)


def test_eval_matches_jax(mha):
    """``seq2seq_eval``'s loss, accuracy and perplexity.  Two rows'
    targets are the model's own greedy continuation (teacher-forced, its
    argmax reproduces them), one row's are random, so the accuracy is
    neither 0 nor 1."""
    jcfg, variables, model = mha
    batch = _batch(seed=2)
    greedy = tm.seq2seq_generate(
        model, torch.as_tensor(batch["encoder_ids"]), max_new_tokens=12)
    batch["targets"][:2] = greedy[:2].numpy()
    jm = jax.jit(jax_s2s.seq2seq_eval(jax_s2s.Seq2SeqLM(jcfg)))(
        variables["params"], {}, batch)
    got = tm.seq2seq_eval(model)(_torch(batch))
    assert set(got) == set(jm) == {"loss", "accuracy", "perplexity"}
    for k in jm:
        np.testing.assert_allclose(float(got[k]), float(jm[k]), rtol=RTOL,
                                   err_msg=k)
    assert 0.5 < float(got["accuracy"]) < 1.0


@pytest.mark.parametrize("variant,eos", [("mha", False), ("mha", True),
                                         ("gqa", False)])
def test_greedy_generate_matches_jax(variant, eos, mha, gqa):
    """``seq2seq_generate`` at temperature 0: the same tokens as JAX's,
    token for token, from padded encoder inputs; with an eos id (one that
    row 0 emits early) each row keeps emitting it from its first."""
    jcfg, variables, model = _pick(variant, mha, gqa)
    enc = _batch(seed=3)["encoder_ids"]
    eos_id = None
    if eos:
        eos_id = int(tm.seq2seq_generate(model, torch.as_tensor(enc[:1]),
                                         max_new_tokens=4)[0, 2])
    j = np.asarray(jax_s2s.seq2seq_generate(
        variables["params"], jnp.asarray(enc), cfg=jcfg, max_new_tokens=10,
        eos_token_id=eos_id))
    t = tm.seq2seq_generate(model, torch.as_tensor(enc), max_new_tokens=10,
                            eos_token_id=eos_id)
    assert t.shape == (3, 10)
    np.testing.assert_array_equal(t.numpy(), j)
    if eos:
        first = int(np.argmax(j[0] == eos_id))
        assert first <= 2 and (t[0, first:] == eos_id).all()


def test_cached_steps_equal_the_teacher_forced_decoder(gqa):
    """The decode-mode steps (the self-attention cache, the cross K/V
    banked on the priming step) give the teacher-forced decoder's states
    position by position, and a fresh cache holds no cross K/V."""
    _, _, model = gqa
    t = _torch(_batch(seed=4))
    with torch.no_grad():
        enc, pad, pos = model.encode(t["encoder_ids"])
        dec_in = tm.shift_right(t["targets"], 0)
        full = model.decode(dec_in, enc, pad, pos)
        cache = model.init_cache(3)
        assert all(c["cross_attention"] == {} for c in cache.values())
        for i in range(dec_in.shape[1]):
            step = model.decode(dec_in[:, i:i + 1], enc, pad, pos,
                                positions=torch.full((3, 1), i),
                                cache=cache)
            _close(step[:, 0], full[:, i].numpy())
    banked = cache["dec_0"]["cross_attention"]["cross_key"]
    assert banked.shape == (3, 16, 2, 32)
    assert cache["dec_0"]["attention"]["cache_index"] == dec_in.shape[1]


def test_second_generate_banks_its_own_cross_kv(mha):
    """A second ``seq2seq_generate`` on other inputs reads its own encoder
    output, not the first call's: its tokens equal a first call's on the
    same inputs."""
    _, _, model = mha
    a = torch.as_tensor(_batch(seed=5)["encoder_ids"])
    b = torch.as_tensor(_batch(seed=6)["encoder_ids"])
    alone = tm.seq2seq_generate(model, b, max_new_tokens=8)
    tm.seq2seq_generate(model, a, max_new_tokens=8)
    after = tm.seq2seq_generate(model, b, max_new_tokens=8)
    assert torch.equal(alone, after)
    assert not torch.equal(alone, tm.seq2seq_generate(model, a,
                                                      max_new_tokens=8))


def test_sampled_generate_is_seeded_and_checked(mha):
    """Sampling (temperature 1) from a ``torch.Generator``: shape (B, N),
    ids in [0, V), the same seed the same tokens; too small a ``max_seq``
    and an over-long stream raise."""
    _, _, model = mha
    enc = torch.as_tensor(_batch(seed=7)["encoder_ids"])

    def run(seed):
        return tm.seq2seq_generate(
            model, enc, max_new_tokens=6, temperature=1.0,
            generator=torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    assert a.shape == (3, 6) and a.dtype == torch.long
    assert int(a.min()) >= 0 and int(a.max()) < model.cfg.vocab_size
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="max_seq"):
        tm.seq2seq_generate(model, enc, max_new_tokens=model.cfg.max_seq)
    with pytest.raises(ValueError, match="exceeds"):
        model.encode(torch.ones((1, model.cfg.max_seq + 1),
                                dtype=torch.long))


def test_dropout_draws_three_sites_a_decoder_block():
    """With a dropout rate the training forward draws its seeds from the
    step's ``DropoutKey`` (two a encoder block, three a decoder block):
    the same key the same states, another key others."""
    cfg = dataclasses.replace(tm.seq2seq_tiny(), dtype=torch.float32,
                              dropout_rate=0.1)
    model = tm.Seq2SeqLM(cfg, device="cpu")
    model.load_state_dict(tm.init_params(cfg,
                                         torch.Generator().manual_seed(0)))
    t = _torch(_batch())

    def run(seed):
        key = DropoutKey(seed)
        out = model(t["encoder_ids"], t["targets"], deterministic=False,
                    generator=key)
        return out, key.sites

    (a, sites), (b, _), (c, _) = run(1), run(1), run(2)
    assert sites == 2 * cfg.enc_layers + 3 * cfg.dec_layers
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_bf16_loss_matches_jax():
    """seq2seq_tiny at the preset's bf16 (the table's rows rounded to
    bf16, enc_out cast to bf16 for cross-attention): the loss within 1e-2
    relative."""
    jcfg, variables, model = _pair("mha", dtype="bf16", seed=1)
    batch = _batch(seed=8)
    jl, _ = jax.jit(lambda p: jax_s2s.seq2seq_loss(jax_s2s.Seq2SeqLM(jcfg))(
        p, {}, batch, jax.random.PRNGKey(0)))(variables["params"])
    with torch.no_grad():
        loss, _ = tm.seq2seq_loss(model)(_torch(batch))
    np.testing.assert_allclose(float(loss), float(jl), rtol=BF16_RTOL)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [4, 21, 4096])
def test_chunked_argmax_matches_jax(chunk, compute):
    """``ops.xent.chunked_argmax`` equals JAX's ids exactly, int32 (B, S):
    chunks of 4 (not dividing the 21 rows), 21 and the default, operands
    in fp32 and bf16; a planted tie (rows 3 and 10 of the table equal,
    the hidden state aligned with them) goes to the first index."""
    rng = np.random.default_rng(9)
    hidden = rng.standard_normal((3, 7, 16)).astype(np.float32)
    wte = rng.standard_normal((50, 16)).astype(np.float32)
    wte[10] = wte[3]
    hidden[1, 2] = 10.0 * wte[3]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[compute]
    tdt = getattr(torch, compute)
    ref = np.asarray(jax_xent.chunked_argmax(
        jnp.asarray(hidden), jnp.asarray(wte), chunk_tokens=chunk,
        compute_dtype=jdt))
    got = txent.chunked_argmax(torch.as_tensor(hidden), torch.as_tensor(wte),
                               chunk_tokens=chunk, compute_dtype=tdt)
    assert got.dtype == torch.int32 and got.shape == (3, 7)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert int(got[1, 2]) == 3


def test_t5_workload_matches_jax():
    """The preset beside JAX's at test size, at its defaults and with the
    overrides (``seq_len`` grows ``max_seq``, ``kv_heads``); the synthetic
    copy-task batches equal JAX's."""
    fields = ("vocab_size", "hidden_size", "num_heads", "enc_layers",
              "dec_layers", "intermediate_size", "max_seq", "dropout_rate",
              "rope_theta", "num_kv_heads", "bos_id", "pad_id")
    for kw in ({"test_size": True}, {},
               {"seq_len": 1024, "kv_heads": 2, "global_batch_size": 16}):
        jw = jax_workloads.get_workload("t5_seq2seq", **kw)
        pw = tw.get_workload("t5_seq2seq", **kw)
        for f in fields:
            assert getattr(pw.cfg, f) == getattr(jw.model.cfg, f), (kw, f)
        assert pw.global_batch_size == jw.global_batch_size
        assert pw.seq_len == jw.init_batch["targets"].shape[1]
    pw = tw.get_workload("t5_seq2seq", test_size=True)
    jw = jax_workloads.get_workload("t5_seq2seq", test_size=True)
    jsrc = jw.input_fn(JaxInputContext(global_batch_size=8,
                                       num_input_pipelines=2,
                                       input_pipeline_id=1), 3)
    tsrc = pw.input_fn(InputContext(global_batch_size=8,
                                    num_input_pipelines=2,
                                    input_pipeline_id=1), 3)
    for _ in range(2):
        jb, tb = next(jsrc), next(tsrc)
        assert jb.keys() == tb.keys()
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])
    model = pw.model_cls(pw.cfg, device="cpu")
    opt = pw.make_optimizer(list(model.named_parameters()))
    assert opt.param_groups[0]["lr"] == 3e-4
    assert opt.param_groups[0]["weight_decay"] == 0.1


def test_train_torch_runs_t5_seq2seq_with_gqa(capsys):
    """``train_torch.py --workload t5_seq2seq --test-size --kv-heads 2``
    on the CPU: the model has two K/V heads, the losses fall over 16
    steps, and each record carries the perplexity and tokens/s."""
    records = train_torch.main(
        ["--workload", "t5_seq2seq", "--test-size", "--device", "cpu",
         "--kv-heads", "2", "--steps", "16", "--log-every", "1"])
    losses = [r["loss"] for r in records]
    assert len(losses) == 16 and all(np.isfinite(losses))
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
    assert set(records[0]) == {"step", "loss", "perplexity", "step_ms",
                               "examples_per_sec", "tokens_per_sec"}
    assert len(capsys.readouterr().out.strip().splitlines()) == 16
    args = train_torch.parse_args(["--workload", "t5_seq2seq", "--test-size",
                                   "--device", "cpu", "--kv-heads", "2"])
    wl, state, _, _ = train_torch.build(args)
    assert wl.cfg.kv_heads == 2
    assert state.model.dec_0.attention.key.weight.shape == (2 * 32, 128)


def test_rmsnorm_matches_flax():
    """``layers.RMSNorm`` against ``flax.linen.RMSNorm(dtype=float32)``
    (epsilon 1e-6, fp32 mean of squares, fp32 out) on fp32 and bf16
    inputs with a random scale: within 1e-6."""
    rng = np.random.default_rng(4)
    scale = (1.0 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    norm = RMSNorm(48, device="cpu")
    with torch.no_grad():
        norm.scale.copy_(torch.as_tensor(scale))
    for dt, tdt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        x = (3.0 * rng.standard_normal((5, 7, 48))).astype(np.float32)
        xj = jnp.asarray(x).astype(dt)
        ref = flax_nn.RMSNorm(dtype=jnp.float32).apply(
            {"params": {"scale": jnp.asarray(scale)}}, xj)
        got = norm(torch.as_tensor(x).to(tdt))
        assert got.dtype == torch.float32 and ref.dtype == jnp.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=0, atol=1e-6)
