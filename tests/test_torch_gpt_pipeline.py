"""The pipeline-parallel GPT of the port against JAX's ``PipelinedGPT``.

``gpt_lm`` at test size in fp32 (gpt_tiny cut to 4 layers, so that two
stages of two chunks hold one layer each; seq 32, a batch of 16 in 8
microbatches, the preset's rule at ``pipe=2``) bound to a ``pipe`` mesh
by the preset's ``for_mesh``, each stage a thread rank: for GPipe, the
circular GPipe (``--pp-virtual 2``), 1F1B and interleaved, the loss on
every stage and the gradients of every parameter (each rank's stage
converted back to JAX's stacked tree) against JAX's ``PipelinedGPT`` on
two of the conftest's eight CPU devices, from JAX's init converted by
``models.convert.pipeline_params_from_flax``; the forward-only eval loss
against the same loss.  Then the ``params_to_dense`` twin (the dense
state and the dense model's logits and loss), the bf16 wire (equal to
the fp32 wire bit for bit, and refused for an fp32 model), pipe x model
(four ranks, the blocks bound by ``bind_tensor_parallel``) and pipe x seq
(four ranks, ring and Ulysses), each against JAX's pipeline of the same
schedule (the same function), the high-water count of saved stage
inputs, the preset through ``train_torch.main`` (its losses those of one
process's dense run), and the flags: the refusals of ``--mesh pipe=N``
and the microbatch rule.

Tolerances (JAX's ``tests/test_gpt_pipeline.py:92-109,354,444``): loss
1e-5 (2e-5 with model or seq), gradients 5e-4 absolute and relative;
the bf16 wire bit for bit.
"""

import dataclasses
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtensorflow_tpu import workloads as jax_workloads
from distributedtensorflow_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from distributedtensorflow_tpu.models.gpt_pipeline import (
    PipelinedGPT as JaxPipelinedGPT,
)
from distributedtensorflow_tpu.models.gpt_pipeline import (
    params_to_dense as jax_params_to_dense,
)
from distributedtensorflow_tpu.models.gpt_pipeline import (
    pipelined_lm_loss as jax_pipelined_lm_loss,
)
from distributedtensorflow_tpu.parallel import MeshSpec as JMeshSpec
from distributedtensorflow_tpu.parallel import build_mesh as jbuild_mesh
from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch import workloads as tw
from distributedtensorflow_tpu_torch.models.convert import (
    pipeline_params_from_flax,
    pipeline_params_to_flax,
)
from distributedtensorflow_tpu_torch.models.gpt_pipeline import (
    PipelinedGPT,
    params_to_dense,
    pipelined_lm_loss,
)
from distributedtensorflow_tpu_torch.parallel import sharding
from distributedtensorflow_tpu_torch.parallel import mesh as tmesh
from distributedtensorflow_tpu_torch.parallel.mesh import MeshSpec
from distributedtensorflow_tpu_torch.parallel.pipeline import fb_schedule
from distributedtensorflow_tpu_torch.testing import run_mesh
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401
from distributedtensorflow_tpu_torch.train import create_sharded_state
from distributedtensorflow_tpu_torch.train.engine import (
    accumulate_gradients_dp,
    make_eval_step,
)
import train_torch

BATCH, SEQ, LAYERS, N_MICRO = 16, 32, 4, 8
CASES = [("gpipe", 1), ("gpipe", 2), ("1f1b", 1), ("interleaved", 2)]


def make_ids(b=BATCH, s=SEQ, vocab=512, seed=3):
    rng = np.random.default_rng(seed)
    start = rng.integers(0, vocab, size=(b, 1))
    step = rng.integers(1, 7, size=(b, 1))
    return ((start + step * np.arange(s)) % vocab).astype(np.int32)


def _flat(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), np.asarray(val, np.float32)


def _tcfg(dtype=torch.float32):
    return dataclasses.replace(tm.gpt_tiny(), dtype=dtype,
                               num_layers=LAYERS)


@pytest.fixture(scope="module")
def jax_runs(devices):
    """JAX's ``PipelinedGPT`` at pipe=2 for each of CASES: its init, the
    loss and the gradients of ``pipelined_lm_loss``."""
    jcfg = dataclasses.replace(jax_gpt_tiny(), dtype=jnp.float32,
                               num_layers=LAYERS)
    jmesh = jbuild_mesh(JMeshSpec(data=1, pipe=2), devices[:2])
    batch = {"input_ids": jnp.asarray(make_ids())}
    out = {}
    for schedule, v in CASES:
        pp = JaxPipelinedGPT(jcfg, jmesh, n_microbatches=N_MICRO,
                             n_virtual=v, schedule=schedule)
        params = pp.init(jax.random.PRNGKey(1))["params"]
        (loss, _), grads = jax.value_and_grad(
            jax_pipelined_lm_loss(pp), has_aux=True)(
                params, {}, batch, jax.random.PRNGKey(0))
        out[schedule, v] = (jax.device_get(params), float(loss),
                            jax.device_get(grads))
    return out


def _port_step(params, spec: MeshSpec, world: int, schedule: str, v: int, *,
               sp_scheme="ring", dtype=torch.float32, handoff=None):
    """One gradient pass of the preset bound to ``spec`` over thread
    ranks, from JAX's ``params``: for each rank its coordinates, its loss
    (the summed shares), its gradients and the eval loss."""
    pw = tw.get_workload("gpt_lm", test_size=True, global_batch_size=BATCH,
                         seq_len=SEQ, sp_scheme=sp_scheme, pp_virtual=v,
                         pp_schedule=schedule, pp_handoff=handoff)
    cfg = _tcfg(dtype)
    batch = {"input_ids": torch.tensor(make_ids(), dtype=torch.long)}

    def body(rank, mesh):
        wl = pw.for_mesh(mesh)
        model = wl.model_cls(cfg, device="cpu")
        assert isinstance(model, PipelinedGPT)
        assert model.n_microbatches == N_MICRO
        model.load_state_dict(pipeline_params_from_flax(
            params, cfg, stage=mesh.coords["pipe"], n_stages=2, n_virtual=v))
        state, _ = create_sharded_state(model, wl.make_optimizer, mesh,
                                        cfg=cfg, rules=wl.layout)
        grads, metrics = accumulate_gradients_dp(
            wl.loss_fn(model, group=mesh), model, batch, mesh, seed=0,
            step=0)
        ev = make_eval_step(wl.eval_fn(model, group=mesh), mesh)(state,
                                                                 batch)
        return (dict(mesh.coords), float(metrics["loss"]), grads,
                float(ev["loss"]), dict(model.last_stats))

    return run_mesh(body, spec, world)


def _whole_grads(outs, cfg, v, layout=None):
    """The gradients of every pipe rank, merged over the model ranks,
    as JAX's stacked tree."""
    by_pipe = {}
    for coords, _, grads, _, _ in outs:
        if coords["seq"] == 0:
            by_pipe.setdefault(coords["pipe"], []).append(
                (coords["model"], grads))
    states = []
    for p in sorted(by_pipe):
        parts = [g for _, g in sorted(by_pipe[p], key=lambda x: x[0])]
        if len(parts) > 1:
            rules = sharding.tp_rules(tm.GPTLM(cfg, device="meta"), cfg,
                                      layout)
            parts = [sharding.unshard_states(parts, rules)]
        states.append(parts[0])
    return pipeline_params_to_flax(states, cfg, n_virtual=v)


def _check(outs, ref_loss, ref_grads, cfg, v, loss_tol=1e-5, layout=None):
    for _, loss, _, eval_loss, _ in outs:
        np.testing.assert_allclose(loss, ref_loss, rtol=loss_tol)
        np.testing.assert_allclose(eval_loss, ref_loss, rtol=loss_tol)
    got = dict(_flat(_whole_grads(outs, cfg, v, layout)))
    ref = dict(_flat(ref_grads))
    assert got.keys() == ref.keys()
    for path, r in ref.items():
        np.testing.assert_allclose(got[path], r, atol=5e-4, rtol=5e-4,
                                   err_msg=path)


@pytest.mark.parametrize("schedule,v", CASES)
def test_pipelined_gpt_matches_jax(jax_runs, schedule, v):
    params, loss, grads = jax_runs[schedule, v]
    outs = _port_step(params, MeshSpec(data=1, pipe=2), 2, schedule, v)
    _check(outs, loss, grads, _tcfg(), v)


@pytest.mark.parametrize("v", [1, 2])
def test_params_to_dense_twin(jax_runs, v):
    """The ranks' states merge into the dense state of JAX's
    ``params_to_dense``; the dense model's loss is the pipeline's and the
    pipeline's logits (on every rank) the dense model's."""
    params, loss, _ = jax_runs["gpipe", v]
    cfg = _tcfg()
    states = [pipeline_params_from_flax(params, cfg, stage=p, n_stages=2,
                                        n_virtual=v) for p in range(2)]
    dense = params_to_dense(states, cfg)
    ref = tm.params_from_flax(jax_params_to_dense(params, cfg, n_virtual=v),
                              cfg)
    assert dense.keys() == ref.keys()
    for k in ref:
        assert torch.equal(dense[k], ref[k]), k
    with pytest.raises(ValueError, match="layers"):
        params_to_dense(states[:1], cfg)
    model = tm.GPTLM(cfg, device="cpu")
    model.load_state_dict(dense)
    ids = torch.tensor(make_ids(), dtype=torch.long)
    dense_loss, _ = tm.lm_loss(model)({"input_ids": ids})
    np.testing.assert_allclose(float(dense_loss.detach()), loss, rtol=1e-5)
    with torch.no_grad():
        want = model(ids)

    def body(rank, mesh):
        pp = PipelinedGPT(cfg, mesh, N_MICRO, n_virtual=v, device="cpu")
        pp.load_state_dict(states[mesh.coords["pipe"]])
        return pp(ids)

    for logits in run_mesh(body, MeshSpec(data=1, pipe=2), 2):
        np.testing.assert_allclose(logits.numpy(), want.numpy(), atol=2e-4,
                                   rtol=2e-4)


def _bf16_grads(schedule, v, handoff, state):
    cfg = _tcfg(torch.bfloat16)
    ids = torch.tensor(make_ids(), dtype=torch.long)

    def body(rank, mesh):
        pp = PipelinedGPT(cfg, mesh, N_MICRO, n_virtual=v, schedule=schedule,
                          handoff_dtype=handoff, device="cpu")
        pp.load_state_dict(tm.convert.pipeline_state(
            state, cfg, stage=mesh.coords["pipe"], n_stages=2, n_virtual=v))
        loss, _ = pipelined_lm_loss(pp)({"input_ids": ids})
        return loss.detach(), torch.autograd.grad(loss, list(pp.parameters()))

    return run_mesh(body, MeshSpec(data=1, pipe=2), 2)


@pytest.mark.parametrize("schedule,v", CASES)
def test_bf16_wire_handoff_bit_exact_and_validated(schedule, v):
    """A bf16 model's stage outputs are bf16 values: the bf16 wire
    carries them exactly, so the loss and every gradient equal the fp32
    wire's bit for bit; an fp32 model or another dtype is refused."""
    state = tm.init_params(_tcfg(), torch.Generator().manual_seed(0))
    wide = _bf16_grads(schedule, v, None, state)
    narrow = _bf16_grads(schedule, v, "bfloat16", state)
    for (l32, g32), (l16, g16) in zip(wide, narrow):
        assert torch.equal(l16, l32)
        for a, b in zip(g16, g32):
            assert torch.equal(a, b)

    def refuse(rank, mesh):
        with pytest.raises(ValueError, match="cfg.dtype"):
            PipelinedGPT(_tcfg(), mesh, N_MICRO, handoff_dtype="bfloat16",
                         device="cpu")
        with pytest.raises(ValueError, match="handoff_dtype"):
            PipelinedGPT(_tcfg(torch.bfloat16), mesh, N_MICRO,
                         handoff_dtype="float16", device="cpu")
        return True

    assert all(run_mesh(refuse, MeshSpec(data=1, pipe=2), 2))


@pytest.mark.parametrize("schedule,v", CASES)
def test_pipe_x_model_matches_jax(jax_runs, schedule, v):
    """data=1,pipe=2,model=2: each stage's blocks split over model by the
    preset's layout (the table whole), every schedule."""
    params, loss, grads = jax_runs[schedule, v]
    outs = _port_step(params, MeshSpec(data=1, pipe=2, model=2), 4,
                      schedule, v)
    _check(outs, loss, grads, _tcfg(), v, loss_tol=2e-5,
           layout=tw.LayoutMap(tm.gpt.GPT_BLOCK_RULES))


@pytest.mark.parametrize("scheme", ["ring", "ulysses"])
@pytest.mark.parametrize("v", [1, 2])
def test_pipe_x_seq_matches_jax(jax_runs, scheme, v):
    """data=1,pipe=2,seq=2 under GPipe: each seq rank's half of the
    sequence through the stages (ring or Ulysses attention), its loss
    a share and its gradients summed over seq by the engine."""
    params, loss, grads = jax_runs["gpipe", v]
    outs = _port_step(params, MeshSpec(data=1, pipe=2, seq=2), 4, "gpipe",
                      v, sp_scheme=scheme)
    _check(outs, loss, grads, _tcfg(), v, loss_tol=2e-5)


def test_saved_stage_inputs_high_water(jax_runs):
    """1F1B holds ``sched.n_slots`` stage inputs at most (on the rank that
    holds the most), below GPipe's one a microbatch."""
    params, _, _ = jax_runs["gpipe", 1]
    high = {}
    for schedule in ("gpipe", "1f1b"):
        outs = _port_step(params, MeshSpec(data=1, pipe=2), 2, schedule, 1)
        high[schedule] = max(o[4]["saved_high"] for o in outs)
    assert high["gpipe"] == N_MICRO
    assert high["1f1b"] == fb_schedule(2, N_MICRO).n_slots < N_MICRO


# ------------------------------------------------------------ train_torch


def _main_on_ranks(argv, spec: MeshSpec, world: int):
    """``train_torch.main(argv)`` on each thread rank, the rank's mesh in
    place of the process group that ``bootstrap_mesh`` would start (a
    process holds one default group; the ranks here are threads)."""
    local = threading.local()
    real = train_torch.bootstrap_mesh

    def body(rank, mesh):
        local.mesh = mesh
        return train_torch.main(argv)

    train_torch.bootstrap_mesh = lambda args: (local.mesh,
                                               torch.device("cpu"))
    try:
        return run_mesh(body, spec, world)
    finally:
        train_torch.bootstrap_mesh = real


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_preset_trains_through_main(schedule):
    """gpt_lm over ``--mesh data=1,pipe=2`` trains with a falling loss,
    every stage's losses those of one process's dense run (fp32, the
    chunked head both ways)."""
    argv = ["--workload", "gpt_lm", "--test-size", "--device", "cpu",
            "--steps", "6", "--log-every", "1", "--dtype", "float32",
            "--xent-impl", "chunked", "--optimizer", "adamw", "--lr",
            "3e-3"]
    dense = [r["loss"] for r in train_torch.main(argv)]
    ranks = _main_on_ranks(argv + ["--mesh", "data=1,pipe=2",
                                   "--pipeline-schedule", schedule],
                           MeshSpec(data=1, pipe=2), 2)
    assert dense[-1] < dense[0]
    for records in ranks:
        np.testing.assert_allclose([r["loss"] for r in records], dense,
                                   rtol=1e-5)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_main_stamps_pipeline_fields_and_resumes(schedule, devices,
                                                 tmp_path):
    """Every ``metrics.jsonl`` record of a ``--mesh data=1,pipe=2`` run
    carries train.py's five ``pipeline_*`` fields with JAX's values (its
    ``PipelinedGPT`` of the same preset on the same mesh), passes the
    schema tool and feeds ``tools/run_report.py``'s pipeline section; with ``--checkpoint-dir`` and ``--clipnorm`` a run cut at
    step 2 and relaunched to step 4 logs the uninterrupted run's losses
    (fp32: within 1e-6 relative, the ranks summing in one order)."""
    from tools import check_metrics_schema, run_report

    argv = ["--workload", "gpt_lm", "--test-size", "--device", "cpu",
            "--log-every", "1", "--dtype", "float32", "--optimizer", "lamb",
            "--lr", "1e-3", "--clipnorm", "0.5", "--mesh", "data=1,pipe=2",
            "--pipeline-schedule", schedule, "--prefetch-depth", "0"]
    spec = MeshSpec(data=1, pipe=2)
    logdir = str(tmp_path / "log")
    whole = _main_on_ranks(argv + ["--steps", "4", "--logdir", logdir],
                           spec, 2)
    jwl = jax_workloads.get_workload("gpt_lm", test_size=True,
                                     pp_schedule=schedule)
    jmodel = jwl.for_mesh(jbuild_mesh(JMeshSpec(data=1, pipe=2),
                                      devices[:2])).model
    want = {"pipeline_schedule": jmodel.schedule,
            "pipeline_stages": jmodel.n_stages,
            "pipeline_microbatches": jmodel.n_microbatches,
            "pipeline_virtual": jmodel.n_virtual,
            "pipeline_bubble": jmodel.bubble_fraction()}
    rows = [json.loads(line) for line in
            open(os.path.join(logdir, "metrics.jsonl"))]
    train_rows = [r for r in rows if "loss" in r]
    # thread ranks share no default group, so each writes as a chief
    assert sorted({r["step"] for r in train_rows}) == [1, 2, 3, 4]
    for row in train_rows:
        assert {k: row[k] for k in want} == pytest.approx(want), row
    assert check_metrics_schema.main(
        [os.path.join(logdir, "metrics.jsonl")]) == 0
    summary = run_report.pipeline_summary(train_rows, [])
    assert summary["schedule"] == schedule and summary["stages"] == 2
    ck = str(tmp_path / "ck")
    cut = _main_on_ranks(argv + ["--steps", "2", "--checkpoint-dir", ck],
                         spec, 2)
    rest = _main_on_ranks(argv + ["--steps", "4", "--checkpoint-dir", ck],
                          spec, 2)
    for r in range(2):
        got = [x["loss"] for x in cut[r] + rest[r]]
        np.testing.assert_allclose(got, [x["loss"] for x in whole[r]],
                                   rtol=1e-6)
        assert [x["step"] for x in rest[r]] == [3, 4]


NOT_PORTED = [("--steps-per-call", "2"), ("--zero",), ("--overlap",),
              ("--dynamics-every", "2"), ("--quant", "int8")]
#: the flags of NOT_PORTED that run over pipe since PR 22; the others
#: still exit "not ported"
LIFTED = {"--zero", "--overlap", "--dynamics-every", "--quant"}


@pytest.mark.parametrize("flag", NOT_PORTED, ids=lambda f: f[0])
def test_pipe_refuses_what_is_not_ported(flag):
    """``--steps-per-call`` > 1 over pipe exits "not ported" (no CUDA
    graph has captured the handoffs); ``--zero``, ``--overlap``,
    ``--dynamics-every`` and ``--quant``, refused until PR 22, pass the
    checks."""
    args = train_torch.parse_args(["--workload", "gpt_lm", "--test-size",
                                   "--device", "cpu", "--mesh",
                                   "data=1,pipe=2", *flag])
    if flag[0] in LIFTED:
        train_torch.check_flags(args)  # runs
        return
    with pytest.raises(SystemExit, match="over a pipe axis is not ported"):
        train_torch.check_flags(args)


def test_pipe_flags_and_usage_errors():
    """The three flags reach the preset; a pipe axis on a preset other
    than the GPT LMs is a usage error; the pipeline's own checks surface
    when the model is built."""
    args = train_torch.parse_args([
        "--workload", "gpt_lm", "--test-size", "--device", "cpu", "--mesh",
        "data=1,pipe=2", "--pipeline-schedule", "interleaved",
        "--pp-virtual", "2", "--pp-handoff-dtype", "bf16"])
    assert (args.pipeline_schedule, args.pp_virtual,
            args.pp_handoff_dtype) == ("interleaved", 2, "bf16")
    train_torch.check_flags(args)  # runs
    for name in ("mnist_lenet", "gpt_moe", "bert_mlm"):
        bad = train_torch.parse_args(["--workload", name, "--mesh",
                                      "data=1,pipe=2"])
        with pytest.raises(SystemExit, match="pipeline is for the GPT LMs"):
            train_torch.check_flags(bad)
    with pytest.raises(ValueError, match="pp_schedule"):
        tw.get_workload("gpt_lm", pp_schedule="zigzag")
    # interleaved at one chunk a stage: refused as the model is built
    with pytest.raises(SystemExit, match="n_virtual >= 2"):
        _main_on_ranks(["--workload", "gpt_lm", "--test-size", "--device",
                        "cpu", "--steps", "1", "--mesh", "data=1,pipe=2",
                        "--pipeline-schedule", "interleaved"],
                       MeshSpec(data=1, pipe=2), 2)


def _mesh(**sizes):
    """A mesh of these axis sizes seen from rank 0, without groups: what
    the model's construction reads."""
    shape = {a: sizes.get(a, 1) for a in tmesh.CANONICAL_AXES}
    return tmesh.Mesh(shape=shape, coords={a: 0 for a in shape})


def test_pipelined_gpt_refuses_as_jax_does(devices):
    """Each of JAX's ``__post_init__`` checks, with its message."""
    jmesh = jbuild_mesh(JMeshSpec(data=1, pipe=2), devices[:2])
    jseq = jbuild_mesh(JMeshSpec(data=1, pipe=2, seq=2), devices[:4])
    jcfg = dataclasses.replace(jax_gpt_tiny(), dtype=jnp.float32,
                               num_layers=LAYERS)
    cases = [dict(n_microbatches=4, n_virtual=0),
             dict(n_microbatches=4, sp_scheme="tree"),
             dict(n_microbatches=4, n_virtual=3),
             dict(n_microbatches=1, n_virtual=2),
             dict(n_microbatches=4, schedule="bogus"),
             dict(n_microbatches=4, n_virtual=2, schedule="1f1b"),
             dict(n_microbatches=4, schedule="interleaved"),
             dict(n_microbatches=3, n_virtual=2, schedule="interleaved"),
             dict(n_microbatches=4, schedule="1f1b", seq=True),
             dict(n_microbatches=4, dropout_rate=0.1)]
    for kw in cases:
        kw = dict(kw)
        seq = kw.pop("seq", False)
        rate = kw.pop("dropout_rate", 0.0)
        with pytest.raises((ValueError, NotImplementedError)) as ours:
            PipelinedGPT(dataclasses.replace(_tcfg(), dropout_rate=rate),
                         _mesh(pipe=2, seq=2 if seq else 1), device="cpu",
                         **kw)
        with pytest.raises(ours.type) as ref:
            JaxPipelinedGPT(dataclasses.replace(jcfg, dropout_rate=rate),
                            jseq if seq else jmesh, **kw)
        assert str(ours.value) == str(ref.value), kw


@pytest.mark.parametrize("data,batch", [(1, 8), (2, 8), (4, 8), (1, 64),
                                        (2, 12), (1, 6)])
def test_microbatch_rule_matches_jax(devices, data, batch):
    """``pipeline_microbatches`` picks JAX's ``finalize``'s count for
    GPipe; the interleaved step-down follows the same rule."""
    jmesh = jbuild_mesh(JMeshSpec(data=data, pipe=2), devices[:2 * data])
    jwl = jax_workloads.get_workload("gpt_lm", test_size=True,
                                     global_batch_size=batch)
    shape = {"data": data, "fsdp": 1, "pipe": 2}
    assert tw.pipeline_microbatches(batch, shape, "gpipe") == \
        jwl.for_mesh(jmesh).model.n_microbatches
    n = tw.pipeline_microbatches(batch, shape, "interleaved")
    local = batch // data
    assert local % n == 0 and (n % 2 == 0 or n <= 2)


@pytest.mark.parametrize("v", [1, 2])
def test_shards_for_rank_over_pipe_and_model(jax_runs, v):
    """``shards_for_rank`` of JAX's pipelined tree at each (pipe, model)
    coordinate is what that rank's ``PipelinedGPT`` holds once its
    blocks are split over model; with JAX's optax state after one AdamW
    update it gives the stage's optimizer state, each moment the rank's
    cut of JAX's (the pipelined optimizer state, once refused)."""
    import optax

    params, _, grads = jax_runs["gpipe", v]
    cfg = _tcfg()
    layout = tw.LayoutMap(tm.gpt.GPT_BLOCK_RULES)
    shape = {"pipe": 2, "model": 2}
    tx = optax.adamw(3e-4, weight_decay=0.1)
    _, jstate = tx.update(grads, tx.init(params), params)
    jstate = jax.device_get(jstate)
    make = tw.get_workload("gpt_lm", test_size=True).make_optimizer
    for p in range(2):
        for r in range(2):
            coords = {"pipe": p, "model": r}
            got = tm.convert.shards_for_rank(
                params, cfg, coords, shape, layout=layout, n_virtual=v,
                opt_state=jstate, make_optimizer=make)
            mesh = _mesh(pipe=2, model=2)
            mesh.coords.update(coords)
            model = PipelinedGPT(cfg, mesh, N_MICRO, n_virtual=v,
                                 device="cpu")
            model.load_state_dict(pipeline_params_from_flax(
                params, cfg, stage=p, n_stages=2, n_virtual=v))
            rules = sharding.tp_rules(model, cfg, layout)
            sharding.bind_tensor_parallel(model, cfg, layout, mesh)
            want = model.state_dict()
            assert got["params"].keys() == want.keys()
            for k, t in want.items():
                assert torch.equal(got["params"][k], t), (p, r, k)
            opt = make(list(model.named_parameters()))
            opt.load_state_dict(got["opt_state"])
            for slot, field in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
                moments = pipeline_params_from_flax(
                    getattr(jstate[0], field), cfg, stage=p, n_stages=2,
                    n_virtual=v)
                moments = sharding.shard_state(moments, rules, r, 2)
                for k, t in model.named_parameters():
                    assert torch.equal(opt.state[t][slot], moments[k]), \
                        (p, r, k, slot)
            assert opt.param_groups[0]["count"] == 1
