"""The port's data-parallel step against the JAX step on the global batch.

N ranks run as threads of this process, each with its own gloo group
(``testing.run_ranks``): every rank builds its model from one converted
JAX init, reads its own input pipeline (seed + rank, as each JAX host
does), and trains through ``make_train_step(..., mesh=...)``.  The
reference is the JAX ``_step_body`` jitted on one device over the global
batch, the ranks' batches concatenated rank-major (the layout of
``make_array_from_process_local_data``).  fp32 at dropout 0.

Tolerances: losses and metrics 1e-5 relative (as the single-device step
tests); gradients of the first step 1e-4 of each leaf's max-abs (as
``tests/test_torch_baseline.py``); BatchNorm running statistics after
three steps 1e-4 of their max-abs (as there).  Between the ranks the
parameters and running statistics are equal bit for bit, and a world of
one is the single-device step bit for bit.  The JAX package is only
called.
"""

import dataclasses
import functools
import json
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtensorflow_tpu import workloads as jax_workloads
from distributedtensorflow_tpu.models import bert as jax_bert
from distributedtensorflow_tpu.models import gpt_moe as jax_gpt_moe
from distributedtensorflow_tpu.models import GPTLM as JaxGPTLM
from distributedtensorflow_tpu.models import gpt_tiny as jax_gpt_tiny
from distributedtensorflow_tpu.models import lm_loss as jax_lm_loss
from distributedtensorflow_tpu.models import seq2seq as jax_s2s
from distributedtensorflow_tpu.models import vit as jax_vit
from distributedtensorflow_tpu.train import engine as jax_engine
from distributedtensorflow_tpu.train import losses as jax_losses
from distributedtensorflow_tpu.train.state import TrainState as JaxTrainState
from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch import train as tt
from distributedtensorflow_tpu_torch import workloads as tw
from distributedtensorflow_tpu_torch.data import InputContext, device_put_batch
from distributedtensorflow_tpu_torch.models.layers import dropout
from distributedtensorflow_tpu_torch.parallel import moe as tmoe
from distributedtensorflow_tpu_torch.parallel.mesh import MeshSpec, build_mesh
from distributedtensorflow_tpu_torch.testing import run_ranks
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
GRAD_TOL = 1e-4
STEPS = 3
PAD_ID = 1  # seq2seq_tiny's pad id


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


def _params(tree):
    return tree.get("params", tree)


def _state_dict(case):
    """The port's state for the case's JAX variables (a GPT config takes
    the parameter tree, a BASELINE model's config the variables)."""
    baseline = type(case.tcfg) in tm.convert.MODELS
    return tm.params_from_flax(
        case.variables if baseline else case.variables["params"], case.tcfg)


@dataclasses.dataclass
class Case:
    """One preset on both sides: the JAX loss and init, the port's config,
    workload (optimizer, input) and loss builder, and the global batch."""

    jloss: object
    variables: dict
    tcfg: object
    pw: object
    batch: int
    loss_builder: object
    skip: tuple = ()


def _gpt_case():
    jw = jax_workloads.get_workload("gpt_lm", test_size=True)
    pw = tw.get_workload("gpt_lm", test_size=True)
    jcfg = dataclasses.replace(jax_gpt_tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(pw.cfg, dtype=torch.float32)
    params = jax.jit(JaxGPTLM(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 64), jnp.int32))["params"]
    return Case(jax_lm_loss(JaxGPTLM(jcfg)), {"params": params}, tcfg, pw,
                8, tm.lm_loss), jw


def _bert_case():
    jw = jax_workloads.get_workload("bert_mlm_packed", test_size=True)
    pw = tw.get_workload("bert_mlm_packed", test_size=True)
    jcfg = dataclasses.replace(jax_bert.bert_tiny(), dtype=jnp.float32,
                               dropout_rate=0.0)
    tcfg = dataclasses.replace(pw.cfg, dtype=torch.float32, dropout_rate=0.0)
    p = tm.max_predictions_for(pw.seq_len)
    variables = jax.jit(jax_bert.BertForMLM(jcfg).init)(
        jax.random.PRNGKey(2), jnp.zeros((2, pw.seq_len), jnp.int32))
    return Case(jax_bert.mlm_loss(jax_bert.BertForMLM(jcfg),
                                  max_predictions=p),
                dict(variables), tcfg, pw, 16,
                functools.partial(tm.mlm_loss, max_predictions=p),
                # a key bias shifts a query's scores by one constant: its
                # gradient is rounding noise on both sides
                skip=("key/bias",)), jw


def _resnet_case():
    jw = jax_workloads.get_workload("cifar_resnet20", test_size=True,
                                    global_batch_size=8)
    pw = tw.get_workload("cifar_resnet20", test_size=True,
                         global_batch_size=8)
    variables = jax.device_get(jw.init_fn(jax.random.PRNGKey(6)))
    return Case(jw.loss_fn, variables, pw.cfg, pw, 8, pw.loss_fn), jw


#: capacity factor 0.5: top-2 over 4 experts keeps a quarter of the
#: tokens' slots per expert, so many assignments drop, and per-rank
#: queues drop other ones than the global queue
MOE_CF = 0.5


def _moe_case():
    jw = jax_workloads.get_workload("gpt_moe", test_size=True)
    pw = tw.get_workload("gpt_moe", test_size=True)
    jcfg = dataclasses.replace(jax_gpt_moe.gpt_moe_tiny(), dtype=jnp.float32,
                               capacity_factor=MOE_CF)
    tcfg = dataclasses.replace(pw.cfg, dtype=torch.float32,
                               capacity_factor=MOE_CF)
    params = jax.jit(jax_gpt_moe.GPTMoELM(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 64), jnp.int32))["params"]
    return Case(jax_gpt_moe.moe_lm_loss(jax_gpt_moe.GPTMoELM(jcfg)),
                {"params": params}, tcfg, pw, 8, tm.moe_lm_loss), jw


def _seq2seq_case():
    """t5_seq2seq at test size (seq 32, global batch 8): the copy task's
    pad tails give each rank's share another count of targets."""
    jw = jax_workloads.get_workload("t5_seq2seq", test_size=True)
    pw = tw.get_workload("t5_seq2seq", test_size=True)
    jmodel = jax_s2s.Seq2SeqLM(dataclasses.replace(jw.model.cfg,
                                                   dtype=jnp.float32))
    tcfg = dataclasses.replace(pw.cfg, dtype=torch.float32)
    z = jnp.zeros((2, pw.seq_len), jnp.int32)
    variables = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(4),
                                                    z, z))
    return Case(jax_s2s.seq2seq_loss(jmodel), dict(variables), tcfg, pw, 8,
                tm.seq2seq_loss), jw


def _vit_case():
    jw = jax_workloads.get_workload("imagenet_vit", test_size=True,
                                    global_batch_size=8)
    pw = tw.get_workload("imagenet_vit", test_size=True, global_batch_size=8)
    jmodel = jax_vit.ViT(dataclasses.replace(jw.model.cfg,
                                             dtype=jnp.float32))
    tcfg = dataclasses.replace(pw.cfg, dtype=torch.float32)
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(5), jnp.zeros((2, 32, 32, 3))))
    return Case(jax_losses.classification_loss(jmodel), dict(variables),
                tcfg, pw, 8, pw.loss_fn), jw


CASES = {"gpt_lm": _gpt_case, "bert_mlm_packed": _bert_case,
         "cifar_resnet20": _resnet_case, "gpt_moe": _moe_case,
         "t5_seq2seq": _seq2seq_case, "imagenet_vit": _vit_case}


@functools.lru_cache(maxsize=None)
def _case(name):
    return CASES[name]()


@functools.lru_cache(maxsize=None)
def _jax_fns(name, accum):
    """The jitted JAX step and gradient accumulation."""
    case, _ = _case(name)
    grads = jax.jit(lambda p, ms, b, rng: jax_engine.accumulate_gradients(
        case.jloss, p, ms, b, rng, accum)[0])
    return jax.jit(jax_engine._step_body(case.jloss, accum)), grads


def _rank_batches(case, world, seed=0):
    """``[rank][step]`` host batches: each rank's own pipeline."""
    out = []
    for rank in range(world):
        src = case.pw.input_fn(InputContext(world, rank, case.batch), seed)
        out.append([next(src) for _ in range(STEPS)])
    return out


@functools.lru_cache(maxsize=None)
def _jax_run(name, world, accum):
    """The JAX step on the global batches (the ranks' pipelines,
    :func:`_rank_batches`): losses and metrics per step, the first step's
    gradients, and the final variables; computed once a module for each
    (preset, world, accumulation)."""
    case, jw = _case(name)
    rank_batches = _rank_batches(case, world)
    params = jax.tree.map(jnp.asarray, case.variables["params"])
    mstate = {k: jax.tree.map(jnp.asarray, v)
              for k, v in case.variables.items() if k != "params"}
    tx = jw.make_optimizer()
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          model_state=mstate, opt_state=tx.init(params),
                          tx=tx)
    step, grad_fn = _jax_fns(name, accum)
    metrics, grads = [], None
    for i in range(STEPS):
        batch = {k: jnp.asarray(np.concatenate([b[i][k]
                                                for b in rank_batches]))
                 for k in rank_batches[0][i]}
        if i == 0:
            rng = jax.random.fold_in(jax.random.PRNGKey(0), 0)
            grads = jax.device_get(grad_fn(state.params, state.model_state,
                                           batch, rng))
        state, m = step(state, batch, jax.random.PRNGKey(0))
        metrics.append({k: float(v) for k, v in m.items()})
    final = jax.device_get({"params": state.params, **state.model_state})
    return metrics, grads, final


def _port_run(name, world, accum, rank_batches, *, route_globally=True):
    """Every rank's ``(metrics per step, first-step gradients, final
    state_dict)`` through the data-parallel step."""
    case, _ = _case(name)
    pw, cfg = case.pw, case.tcfg
    state_dict = _state_dict(case)

    def body(rank, group):
        mesh = build_mesh(MeshSpec(data=world), group)
        kw = {"group": mesh} if pw.model_takes_group and route_globally \
            else {}
        model = pw.model_cls(cfg, device="cpu", **kw)
        model.load_state_dict(state_dict)
        state = tt.TrainState.create(model, pw.make_optimizer, mesh)
        step = tt.make_train_step(case.loss_builder(model, group=mesh),
                                  accum_steps=accum, mesh=mesh)
        grads = {}
        apply = state.apply_gradients

        def record(g):
            if not grads:
                grads.update({k: v.clone() for k, v in g.items()})
            return apply(g)

        state.apply_gradients = record
        metrics = []
        for host in rank_batches[rank]:
            state, m = step(state, device_put_batch(host, "cpu", mesh,
                                                    accum_steps=accum))
            metrics.append({k: float(v) for k, v in m.items()})
        return metrics, grads, model.state_dict()

    return run_ranks(body, world)


def _check_against_jax(name, world, accum):
    case, _ = _case(name)
    batches = _rank_batches(case, world)
    ref, jgrads, final = _jax_run(name, world, accum)
    outs = _port_run(name, world, accum, batches)
    for metrics, _, _ in outs:
        for got, want in zip(metrics, ref):
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                           atol=1e-7, err_msg=k)
    _, grads, sd = outs[0]
    _assert_trees_close(_params(tm.params_to_flax(grads, case.tcfg)),
                        _params(jgrads), GRAD_TOL, case.skip)
    for _, _, other in outs[1:]:  # one replica on every rank
        for k in sd:
            assert torch.equal(other[k], sd[k]), k
    if "batch_stats" in final:
        _assert_trees_close(tm.params_to_flax(sd, case.tcfg)["batch_stats"],
                            final["batch_stats"], GRAD_TOL)
    return batches, outs


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("accum", [1, 2])
def test_gpt_lm_matches_jax_global_batch(world, accum):
    """gpt_lm at test size, fp32, AdamW: three steps' losses and
    perplexities, the first step's gradients."""
    _check_against_jax("gpt_lm", world, accum)


@pytest.mark.parametrize("world", [2, 4])
def test_bert_packed_accum4_matches_jax_global_batch(world):
    """bert_mlm_packed at test size (seq 128, global batch 16, four
    microbatches): the loss divides by the global microbatch's masked
    positions, which differ between the ranks' shares."""
    batches, _ = _check_against_jax("bert_mlm_packed", world, 4)
    # the ranks' shares of global microbatch 0 hold different counts of
    # MLM weights
    labels = np.concatenate([b[0]["labels"] for b in batches])[:16 // 4]
    counts = {int((share >= 0).sum()) for share in np.split(labels, world)}
    assert len(counts) > 1


@pytest.mark.parametrize("world", [2, 4])
def test_resnet20_global_batch_norm_matches_jax(world):
    """cifar_resnet20 at test size (fp32, global batch 8, loss-side L2
    1e-4 entered once): losses and accuracy, the first step's gradients,
    and the running statistics, which every rank holds alike."""
    _check_against_jax("cifar_resnet20", world, 1)


@pytest.mark.parametrize("world", [2, 4])
def test_gpt_moe_routes_the_global_batch(world):
    """gpt_moe_tiny (fp32, capacity factor 0.5, so many assignments
    drop): with global routing the losses (LM and aux) and gradients
    match JAX's; routing each rank's tokens on their own drops other
    assignments and misses JAX's losses."""
    batches, _ = _check_against_jax("gpt_moe", world, 1)
    ref = _jax_run("gpt_moe", world, 1)[0]
    local = _port_run("gpt_moe", world, 1, batches, route_globally=False)
    diffs = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
             for a, b in zip(local[0][0], ref)]
    assert max(diffs) > 10 * RTOL


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("accum", [1, 2])
def test_t5_seq2seq_matches_jax_global_batch(world, accum):
    """t5_seq2seq at test size (fp32, AdamW): three steps' losses and
    perplexities, the first step's gradients.  The pad-masked mean
    divides by the global microbatch's non-pad targets, which differ
    between the ranks' shares."""
    batches, _ = _check_against_jax("t5_seq2seq", world, accum)
    targets = np.concatenate([b[0]["targets"] for b in batches])
    counts = {int((share != PAD_ID).sum())
              for share in np.split(targets[:8 // accum], world)}
    assert len(counts) > 1


@pytest.mark.parametrize("world", [2, 4])
def test_imagenet_vit_matches_jax_global_batch(world):
    """imagenet_vit at test size (fp32, global batch 8, AdamW on its
    warm-up cosine): losses and accuracy, the first step's gradients."""
    _check_against_jax("imagenet_vit", world, 1)


def test_seq2seq_eval_shares_sum_to_the_global_batch():
    """Two thread ranks' ``seq2seq_eval`` through ``make_eval_step``: the
    loss, accuracy and perplexity of the global eval batch (1e-6
    relative; fp32), each rank holding half the rows."""
    case, _ = _case("t5_seq2seq")
    batch = next(case.pw.input_fn(InputContext(global_batch_size=8), 7))
    sd = _state_dict(case)

    def metrics(rank, group):
        model = tm.Seq2SeqLM(case.tcfg, device="cpu")
        model.load_state_dict(sd)
        mesh = None if group is None else build_mesh(MeshSpec(data=2), group)
        step = tt.make_eval_step(tm.seq2seq_eval(model, group=mesh), mesh)
        rows = {k: np.split(v, 2)[rank] if mesh is not None else v
                for k, v in batch.items()}
        return {k: float(v) for k, v in step(
            None, device_put_batch(rows, "cpu")).items()}

    ref = metrics(0, None)
    for got in run_ranks(metrics, 2):
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("router", ["top1", "top2"])
@pytest.mark.parametrize("masked", [False, True])
def test_global_routing_positions_and_drops(router, masked):
    """Two ranks' halves of a token set routed over the group get the
    global router's kept rows, outputs and summed aux loss (1e-6), with
    and without a token mask; each half routed alone drops other
    assignments."""
    g = torch.Generator().manual_seed(3)
    tokens = torch.randn(64, 16, generator=g)
    kernel = torch.randn(16, 4, generator=g)
    params = {"w": torch.randn(4, 16, 16, generator=g)}
    mask = (torch.rand(64, generator=g) > 0.25).float() if masked else None

    def expert(p, x):
        return torch.bmm(x, p["w"])

    def route(toks, tmask, group=None):
        """The kept rows (expert, slot) and the MoE output and aux."""
        cap = tmoe.capacity_for(toks.shape[0] * (2 if group else 1), 4, 0.5,
                                router)
        logits = toks.float() @ kernel.float()
        e, s, keep, _, _ = tmoe.ROUTERS[router](logits, cap, tmask, group)
        rows = {(int(a), int(b)) for a, b, k in zip(e.flatten(), s.flatten(),
                                                     keep.flatten()) if k}
        out, aux = tmoe.local_moe(toks, kernel, params, expert,
                                  capacity_factor=0.5, router=router,
                                  token_mask=tmask, group=group)
        return rows, out, aux

    ref_rows, ref, ref_aux = route(tokens, mask)

    def body(rank, group):
        mine = tokens.chunk(2)[rank]
        mmask = None if mask is None else mask.chunk(2)[rank]
        rows, out, aux = route(mine, mmask, group)
        _, alone, _ = route(mine, mmask)
        return len(rows), out, aux, alone

    outs = run_ranks(body, 2)
    assert outs[0][0] + outs[1][0] == len(ref_rows)
    torch.testing.assert_close(torch.cat([o[1] for o in outs]), ref)
    torch.testing.assert_close(outs[0][2] + outs[1][2], ref_aux, rtol=0,
                               atol=1e-6)
    assert not torch.allclose(torch.cat([o[3] for o in outs]), ref)


@pytest.mark.parametrize("name,accum", [("gpt_lm", 2),
                                        ("bert_mlm_packed", 4),
                                        ("cifar_resnet20", 1),
                                        ("gpt_moe", 1),
                                        ("t5_seq2seq", 2),
                                        ("imagenet_vit", 1)])
def test_world_of_one_is_the_single_device_step_bit_for_bit(name, accum):
    """A mesh of one rank (its own gloo group) gives the plain step's
    metrics, parameters and buffers bit for bit.  One intra-op thread:
    torch's multi-threaded CPU reductions (the embedding's backward among
    them) differ in their last bits from run to run, the plain step's
    included."""
    case, _ = _case(name)
    batches = _rank_batches(case, 1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        (dp_metrics, _, dp_sd), = _port_run(name, 1, accum, batches)
        model = case.pw.model_cls(case.tcfg, device="cpu")
        model.load_state_dict(_state_dict(case))
        state = tt.TrainState.create(model, case.pw.make_optimizer)
        step = tt.make_train_step(case.loss_builder(model),
                                  accum_steps=accum)
        for host, want in zip(batches[0], dp_metrics):
            state, m = step(state, device_put_batch(host, "cpu"))
            assert {k: float(v) for k, v in m.items()} == want
    finally:
        torch.set_num_threads(threads)
    for k, v in model.state_dict().items():
        assert torch.equal(v, dp_sd[k]), k


def test_masked_lm_loss_divides_by_the_global_target_count():
    """With a ``mask`` that keeps other counts of targets on each rank,
    the ranks' loss shares and their gradients sum to the global batch's
    masked mean (1e-6 relative; fp32), where a mean of the ranks' means
    misses it."""
    cfg = dataclasses.replace(tm.gpt_tiny(), dtype=torch.float32)
    sd = tm.init_params(cfg, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(2)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 32)))
    mask = torch.as_tensor(rng.random((4, 32)) < np.array(
        [0.9, 0.8, 0.3, 0.2])[:, None]).long()

    def loss_and_grad(batch, group=None):
        model = tm.GPTLM(cfg, device="cpu")
        model.load_state_dict(sd)
        loss, m = tm.lm_loss(model, group=group)(batch)
        loss.backward()
        return float(loss.detach()), model.h[0].attn.qkv.weight.grad, m

    ref, ref_grad, _ = loss_and_grad({"input_ids": ids, "mask": mask})
    outs = run_ranks(lambda r, g: loss_and_grad(
        {"input_ids": ids.chunk(2)[r], "mask": mask.chunk(2)[r]}, g), 2)
    np.testing.assert_allclose(sum(o[0] for o in outs), ref, rtol=1e-6)
    torch.testing.assert_close(outs[0][1] + outs[1][1], ref_grad,
                               rtol=1e-5, atol=1e-7)
    assert set(outs[0][2]) == {"log_perplexity"}
    local_means = [loss_and_grad({"input_ids": ids.chunk(2)[r],
                                  "mask": mask.chunk(2)[r]})[0]
                   for r in range(2)]
    assert abs(np.mean(local_means) - ref) > 1e-3 * ref


def test_ranks_draw_their_own_dropout_bits():
    """Rank 0 draws what one device draws; other ranks draw other
    masks for the same step and microbatch."""
    x = torch.ones(4, 256)
    masks = [dropout(x, 0.5, int(torch.randint(
        2**62, (), generator=tt.step_generator(0, 3, 1, rank))))
        for rank in range(3)]
    plain = dropout(x, 0.5, int(torch.randint(
        2**62, (), generator=tt.step_generator(0, 3, 1))))
    assert torch.equal(masks[0], plain)
    assert not torch.equal(masks[0], masks[1])
    assert not torch.equal(masks[1], masks[2])


@pytest.mark.slow  # spawns two processes
def test_launcher_two_ranks_match_one_process(tmp_path):
    """``run_distributed_torch.sh -n 2`` trains gpt_lm at test size over
    gloo on the CPU: the chief's three losses equal one process's steps
    on the same global batch (both ranks' pipelines, rank-major) within
    1e-5, and only the chief writes metrics.jsonl.  In fp32: in the
    preset's bf16 each rank rounds the weight gradients of its own rows
    to bf16 before the sum, which moves the losses from the second step
    on by more than 1e-5."""
    logdir = tmp_path / "run"
    out = subprocess.run(
        ["bash", os.path.join(REPO, "run_distributed_torch.sh"), "-n", "2",
         "-p", "29617", "--", "--workload", "gpt_lm", "--test-size",
         "--device", "cpu", "--dist-backend", "gloo", "--steps", "3",
         "--dtype", "float32",
         "--log-every", "1", "--logdir", str(logdir)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(s) for s in out.stdout.splitlines()
             if s.startswith("{")]
    assert [r["step"] for r in lines] == [1, 2, 3]  # the chief's only
    rows = (logdir / "metrics.jsonl").read_text().splitlines()
    assert len(rows) == 3
    pw = tw.get_workload("gpt_lm", test_size=True)
    cfg = dataclasses.replace(pw.cfg, dtype=torch.float32)
    model = pw.model_cls(cfg, device="cpu")
    model.load_state_dict(pw.init_params(cfg,
                                         torch.Generator().manual_seed(0)))
    state = tt.TrainState.create(model, pw.make_optimizer)
    step = tt.make_train_step(pw.loss_fn(model))
    srcs = [pw.input_fn(InputContext(2, r, pw.global_batch_size), 0)
            for r in range(2)]
    for rec in lines:
        parts = [next(s) for s in srcs]
        batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        state, m = step(state, device_put_batch(batch, "cpu"))
        np.testing.assert_allclose(rec["loss"], float(m["loss"]), rtol=RTOL)
