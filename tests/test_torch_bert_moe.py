"""The port's expert-choice routing and BERT-MoE against the JAX package's.

``expert_choice_route`` and ``local_moe`` on numpy-seeded router logits
and tokens (with pads and with deliberate ties), ``BertMoEForMLM`` from
one flax ``init`` moved across with ``params_from_flax`` in fp32 at
dropout 0 (expert choice and the top-1/top-2 ablations), and the
data-parallel step of the ``bert_moe`` preset over two thread ranks
against JAX's ``_step_body`` on the global batch.  Tolerances: token
sets and kept flags exactly; gates, outputs and losses 1e-5 relative (of
the output's max-abs); gradients 1e-4 of a leaf's max-abs.  The JAX
package is only called.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtensorflow_tpu import workloads as jax_workloads
from distributedtensorflow_tpu.models import bert_moe as jax_bert_moe
from distributedtensorflow_tpu.models import gpt_moe as jax_gpt_moe
from distributedtensorflow_tpu.parallel import moe as jax_moe
from distributedtensorflow_tpu.train import engine as jax_engine
from distributedtensorflow_tpu.train.state import TrainState as JaxTrainState
from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch import train as tt
from distributedtensorflow_tpu_torch import workloads as tw
from distributedtensorflow_tpu_torch.data import InputContext, device_put_batch
from distributedtensorflow_tpu_torch.models import gpt_moe as tgpt_moe
from distributedtensorflow_tpu_torch.parallel import moe as tmoe
from distributedtensorflow_tpu_torch.parallel.mesh import MeshSpec, build_mesh
from distributedtensorflow_tpu_torch.testing import run_ranks
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401

RTOL = 1e-5
GRAD_TOL = 1e-4


def _flat(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def _assert_trees_close(got, ref, rel, skip=()):
    got, ref = dict(_flat(got)), dict(_flat(ref))
    assert got.keys() == ref.keys()
    for path, r in ref.items():
        name = "/".join(path)
        if any(s in name for s in skip):
            continue
        np.testing.assert_allclose(got[path], r, rtol=0,
                                   atol=rel * np.abs(r).max(), err_msg=name)


def _close(got, ref, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-30))


# ------------------------------------------------------------------ router

#: (tokens, experts, capacity, pads?, ties?): ties draw the logits from
#: three values, so most of an expert's candidates tie; pads leave fewer
#: real tokens than an expert's capacity, so pads reach a top-k.
ROUTE_CASES = {"plain": (48, 4, 15, False, False),
               "pads": (48, 4, 15, True, False),
               "ties": (48, 4, 15, False, True),
               "ties_pads": (40, 8, 30, True, True)}


def _route_inputs(case):
    t, e, cap, pads, ties = ROUTE_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    logits = (rng.integers(0, 3, (t, e)).astype(np.float32) if ties
              else rng.standard_normal((t, e)).astype(np.float32))
    mask = (rng.random(t) < 0.4).astype(np.float32) if pads else None
    return logits, mask, cap


def _jax_choices(dispatch, combine):
    """JAX's (T, E, C) one-hot dispatch as expert-major (E, C) token
    indices (-1 where a slot holds nothing) and gates."""
    d = np.asarray(dispatch)
    token = np.where(d.sum(0) > 0, d.argmax(0), -1)
    return token, np.asarray(combine).sum(0)


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_expert_choice_route_matches_jax(case):
    """Each expert's chosen tokens, slot by slot, and their gates equal
    ``expert_choice_route``'s (ties to the lower index, pads below every
    real token and never kept); the aux loss is exactly 0."""
    logits, mask, cap = _route_inputs(case)
    jd, jc, jaux = jax_moe.expert_choice_route(
        jnp.asarray(logits), cap,
        None if mask is None else jnp.asarray(mask))
    jtoken, jgate = _jax_choices(jd, jc)
    token, gate, keep, aux = tmoe.expert_choice_route(
        torch.tensor(logits), cap,
        None if mask is None else torch.tensor(mask))
    assert token.shape == jtoken.shape == (logits.shape[1],
                                           min(cap, logits.shape[0]))
    np.testing.assert_array_equal(np.where(keep.numpy(), token.numpy(), -1),
                                  jtoken)
    _close(torch.where(keep, gate, 0.0), jgate)
    assert float(aux) == float(jaux) == 0.0
    if mask is not None:  # some pads did reach a top-k and were dropped
        assert (~keep).any()
        assert (mask[token.numpy()][keep.numpy()] == 1).all()


@pytest.mark.parametrize("case", ["plain", "ties_pads"])
def test_local_moe_expert_choice_matches_jax(case):
    """``local_moe`` with expert choice against JAX's: the output and
    the gradients of the tokens, the router and the experts (fp32), and
    a second run repeats both bit for bit."""
    logits, mask, _ = _route_inputs(case)
    t, e = logits.shape
    d, f = 16, 32
    rng = np.random.default_rng(7)
    tokens = rng.standard_normal((t, d)).astype(np.float32)
    kernel = rng.standard_normal((d, e)).astype(np.float32)
    w_in = (rng.standard_normal((e, d, f)) / 4).astype(np.float32)
    w_out = (rng.standard_normal((e, f, d)) / 4).astype(np.float32)
    probe = rng.standard_normal((t, d)).astype(np.float32)
    jmask = None if mask is None else jnp.asarray(mask)

    def jloss(x, k, wi, wo):
        out, _ = jax_moe.local_moe(
            x, k, {"w_in": wi, "w_out": wo}, jax_gpt_moe._expert_mlp,
            capacity_factor=1.25, router="expert_choice", token_mask=jmask)
        return jnp.sum(out * probe), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True))(
        *map(jnp.asarray, (tokens, kernel, w_in, w_out)))

    def run():
        leaves = [torch.tensor(a, requires_grad=True)
                  for a in (tokens, kernel, w_in, w_out)]
        out, aux = tmoe.local_moe(
            leaves[0], leaves[1], {"w_in": leaves[2], "w_out": leaves[3]},
            tgpt_moe._expert_mlp, capacity_factor=1.25,
            router="expert_choice",
            token_mask=None if mask is None else torch.tensor(mask))
        (out * torch.tensor(probe)).sum().backward()
        assert float(aux) == 0.0
        return out.detach(), [x.grad for x in leaves]

    out, grads = run()
    _close(out, jout)
    for got, ref in zip(grads, jgrads):
        _close(got, ref, GRAD_TOL)
    again, grads2 = run()
    assert torch.equal(out, again)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))


def test_expert_choice_over_ranks_is_the_global_selection():
    """Two ranks' halves of a token set (with pads) routed over the group
    together give the one-process output of the whole set; each half
    routed alone selects within itself and differs."""
    logits, mask, _ = _route_inputs("ties_pads")
    g = torch.Generator().manual_seed(5)
    tokens = torch.randn(logits.shape[0], 16, generator=g)
    kernel = torch.randn(16, logits.shape[1], generator=g)
    params = {"w": torch.randn(logits.shape[1], 16, 16, generator=g)}
    tmask = torch.tensor(mask)

    def expert(p, x):
        return torch.bmm(x, p["w"])

    def run(toks, m, group=None):
        return tmoe.local_moe(toks, kernel, params, expert,
                              capacity_factor=1.25, router="expert_choice",
                              token_mask=m, group=group)[0]

    ref = run(tokens, tmask)

    def body(rank, group):
        mine, m = tokens.chunk(2)[rank], tmask.chunk(2)[rank]
        return run(mine, m, group), run(mine, m)

    outs = run_ranks(body, 2)
    torch.testing.assert_close(torch.cat([o[0] for o in outs]), ref,
                               rtol=0, atol=1e-6)
    assert not torch.allclose(torch.cat([o[1] for o in outs]), ref)


# ------------------------------------------------------------------- model


def _cfgs(router="expert_choice"):
    jcfg = dataclasses.replace(jax_bert_moe.bert_moe_tiny(),
                               dtype=jnp.float32, dropout_rate=0.0,
                               router=router)
    tcfg = dataclasses.replace(tm.bert_moe_tiny(), dtype=torch.float32,
                               dropout_rate=0.0, router=router)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def bert_moe_vars():
    jcfg, _ = _cfgs()
    return jax.device_get(jax.jit(jax_bert_moe.BertMoEForMLM(jcfg).init)(
        jax.random.PRNGKey(1), jnp.zeros((2, 32), jnp.int32)))


def _mlm_batch(b=4, seq=32, vocab=1024, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, vocab, (b, seq)).astype(np.int32)
    labels = np.where(rng.random((b, seq)) < 0.15, ids, -100).astype(np.int32)
    attn = np.ones((b, seq), np.int32)
    attn[1, seq // 2:] = 0  # a padded row: its pads take no expert slot
    attn[3, seq - 5:] = 0
    return {"input_ids": np.where(labels >= 0, 3, ids).astype(np.int32),
            "labels": labels, "attention_mask": attn}


@pytest.mark.parametrize("router", ["expert_choice", "top1", "top2"])
def test_bert_moe_logits_loss_and_grads_match_jax(bert_moe_vars, router):
    """``BertMoEForMLM`` (2 layers, block 1 routed over 4 experts) from
    the flax init: logits and aux of a padded batch, and ``moe_mlm_loss``
    (gathered head, aux weight 1e-2) with its gradients, under expert
    choice and the top-1/top-2 ablations, whose aux loss is live."""
    jcfg, tcfg = _cfgs(router)
    jmodel = jax_bert_moe.BertMoEForMLM(jcfg)
    model = tm.BertMoEForMLM(tcfg, device="cpu")
    model.load_state_dict(tm.params_from_flax(bert_moe_vars, tcfg))
    batch = _mlm_batch()
    jlogits, jaux = jax.jit(jmodel.apply)(
        bert_moe_vars, jnp.asarray(batch["input_ids"]),
        attention_mask=jnp.asarray(batch["attention_mask"]))
    tb = {k: torch.as_tensor(v, dtype=torch.long) for k, v in batch.items()}
    with torch.no_grad():
        logits, aux = model(tb["input_ids"],
                            attention_mask=tb["attention_mask"])
    _close(logits, jlogits)
    _close(aux, jaux)
    assert (float(jaux) == 0.0) == (router == "expert_choice")
    p = tm.max_predictions_for(32)
    jloss_fn = jax_bert_moe.moe_mlm_loss(jmodel, max_predictions=p)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, (jm, _)), jgrads = jax.jit(jax.value_and_grad(
        lambda prm: jloss_fn(prm, {}, jb, None), has_aux=True))(
        bert_moe_vars["params"])
    # the port's loss at dropout 0 is the deterministic forward JAX takes
    # with rng=None
    loss, metrics = tm.moe_mlm_loss(model, max_predictions=p)(tb)
    loss.backward()
    _close(loss, jloss)
    for k in ("mlm_accuracy", "moe_aux_loss", "mlm_clipped_rows"):
        _close(metrics[k], jm[k])
    grads = {n: q.grad for n, q in model.named_parameters()}
    # a key bias shifts a query's scores by one constant: its gradient is
    # rounding noise on both sides
    _assert_trees_close(tm.params_to_flax(grads, tcfg)["params"], jgrads,
                        GRAD_TOL, skip=("key/bias",))


def test_bert_moe_params_round_trip_and_init(bert_moe_vars):
    """The flax tree moves to the port and back leaf for leaf, MoE block
    names included; the seeded init draws routers at 0.02 and experts at
    1/sqrt(E x in)."""
    _, tcfg = _cfgs()
    state = tm.params_from_flax(bert_moe_vars, tcfg)
    assert "encoder.layer_1.moe_mlp.router" in state
    assert "encoder.layer_0.mlp_in.weight" in state
    assert "encoder.layer_1.mlp_in.weight" not in state
    back = tm.params_to_flax(state, tcfg)
    for path, leaf in _flat(bert_moe_vars):
        got = back
        for key in path:
            got = got[key]
        np.testing.assert_array_equal(got, leaf)
    init = tm.init_params(tcfg, torch.Generator().manual_seed(0))
    router = init["encoder.layer_1.moe_mlp.router"]
    experts = init["encoder.layer_1.moe_mlp.experts_in"]
    assert abs(float(router.std()) - 0.02) < 0.005
    want = 1 / np.sqrt(experts.shape[0] * experts.shape[1])
    assert abs(float(experts.std()) - want) < 0.1 * want


def test_gpt_moe_still_refuses_expert_choice():
    cfg = dataclasses.replace(tm.gpt_moe_tiny(), router="expert_choice")
    with pytest.raises(ValueError, match="non-causal"):
        tm.GPTMoELM(cfg, device="cpu")


# -------------------------------------------------------------- preset / dp

DP_BATCH, DP_ACCUM, DP_STEPS = 8, 2, 2


def test_bert_moe_preset_two_ranks_match_jax_global_batch(bert_moe_vars):
    """The ``bert_moe`` preset at test size (fp32, dropout 0, global batch
    8 in 2 microbatches, AdamW 1e-4): two ``data`` ranks, each with its
    own pipeline, match JAX's ``_step_body`` on the global batch: losses
    and metrics of two steps, the first step's gradients; the ranks hold
    one replica.  Each expert's top-k is over both ranks' tokens."""
    jw = jax_workloads.get_workload("bert_moe", test_size=True,
                                    global_batch_size=DP_BATCH)
    pw = tw.get_workload("bert_moe", test_size=True,
                         global_batch_size=DP_BATCH)
    jcfg = dataclasses.replace(jw.model.cfg, dtype=jnp.float32,
                               dropout_rate=0.0)
    tcfg = dataclasses.replace(pw.cfg, dtype=torch.float32, dropout_rate=0.0)
    jmodel = jax_bert_moe.BertMoEForMLM(jcfg)
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(3), jnp.zeros((2, pw.seq_len), jnp.int32)))
    p = tm.max_predictions_for(pw.seq_len)
    jloss = jax_bert_moe.moe_mlm_loss(jmodel, max_predictions=p)
    rank_batches = []
    for rank in range(2):
        src = pw.input_fn(InputContext(2, rank, DP_BATCH), 0)
        rank_batches.append([next(src) for _ in range(DP_STEPS)])
    tx = jw.make_optimizer()
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           model_state={}, opt_state=tx.init(params), tx=tx)
    jstep = jax.jit(jax_engine._step_body(jloss, DP_ACCUM))
    grad_fn = jax.jit(lambda prm, b, rng: jax_engine.accumulate_gradients(
        jloss, prm, {}, b, rng, DP_ACCUM)[0])
    ref, jgrads = [], None
    for i in range(DP_STEPS):
        batch = {k: jnp.asarray(np.concatenate([b[i][k]
                                                for b in rank_batches]))
                 for k in rank_batches[0][i]}
        if i == 0:
            jgrads = jax.device_get(grad_fn(
                jstate.params, batch,
                jax.random.fold_in(jax.random.PRNGKey(0), 0)))
        jstate, m = jstep(jstate, batch, jax.random.PRNGKey(0))
        ref.append({k: float(v) for k, v in m.items()})
    state_dict = tm.params_from_flax(variables, tcfg)

    def body(rank, group):
        mesh = build_mesh(MeshSpec(data=2), group)
        model = pw.model_cls(tcfg, device="cpu", group=mesh)
        model.load_state_dict(state_dict)
        state = tt.TrainState.create(model, pw.make_optimizer, mesh)
        step = tt.make_train_step(pw.loss_fn(model, group=mesh),
                                  accum_steps=DP_ACCUM, mesh=mesh)
        grads, apply = {}, state.apply_gradients

        def record(g):
            if not grads:
                grads.update({k: v.clone() for k, v in g.items()})
            return apply(g)

        state.apply_gradients = record
        metrics = []
        for host in rank_batches[rank]:
            state, m = step(state, device_put_batch(
                host, "cpu", mesh, accum_steps=DP_ACCUM))
            metrics.append({k: float(v) for k, v in m.items()})
        return metrics, grads, model.state_dict()

    outs = run_ranks(body, 2)
    for metrics, _, _ in outs:
        for got, want in zip(metrics, ref):
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                           atol=1e-7, err_msg=k)
    _assert_trees_close(tm.params_to_flax(outs[0][1], tcfg)["params"],
                        jgrads, GRAD_TOL, skip=("key/bias",))
    for k, v in outs[0][2].items():
        assert torch.equal(outs[1][2][k], v), k


def test_bert_moe_trains_k_steps_a_call_as_one_at_a_time():
    """``train_torch.py --workload bert_moe --steps-per-call 2`` (on the
    CPU a loop over the same steps) repeats the one-step run's losses bit
    for bit, dropout and expert choice included (fp32: the CPU's bf16
    products are slow)."""
    import train_torch

    argv = ["--workload", "bert_moe", "--test-size", "--device", "cpu",
            "--batch-size", "4", "--steps", "4", "--log-every", "2",
            "--prefetch-depth", "0", "--dtype", "float32"]
    one = train_torch.main(argv)
    two = train_torch.main(argv + ["--steps-per-call", "2"])
    assert [r["loss"] for r in one] == [r["loss"] for r in two]
    assert all(np.isfinite(r["loss"]) for r in one)
