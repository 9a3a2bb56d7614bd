"""Checkpoints of split runs: one process's file, and any layout restores.

JAX's Orbax saves global arrays and restores them into whatever sharding
the target has; the port keeps that meaning (``parallel.placement``,
``checkpoint.CheckpointManager``): the step directory of a run split over
``model``, ``expert`` or ``pipe`` (and ZeRO's rows) is the one a single
process writes for the same state, and each rank of any layout cuts its
pieces from it.  gpt_lm at test size (gpt_tiny, fp32) and gpt_moe_tiny,
thread ranks, the preset's AdamW (elementwise: a piece's update is the
whole update's elements, bit for bit):

- two updates from the same whole gradients (each rank given its cut of
  them) over ``data=1,model=2``, ``data=1,expert=2``, ``data=1,pipe=2``
  (GPipe and 1F1B) and ``data=2`` with ``model=2``, ``pipe=2`` (1F1B)
  or ``expert=2`` under ZeRO save a ``state.pt``
  equal, tensor for tensor, to one process's after the same updates
  (ZeRO's slots are their ``(2, chunk)`` views of the whole slot);
- a ``model=2`` checkpoint restores into one process and into ``pipe=2``,
  a one-process checkpoint into ``model=2``: every rank's parameters and
  optimizer slots are its cut of the file's; a ZeRO save over
  ``data=2,pipe=2`` restores into one process through
  ``restore_latest_zero`` (its slots unchunked from the saved views);
- over ``model=2`` and ``pipe=2`` two steps, an asynchronous save, a
  fresh build from another seed, ``restore_latest`` and two more steps
  equal four uninterrupted steps bit for bit (losses and parameters; one
  intra-op thread, as the CPU's embedding backward is not bit-repeatable
  across threads);
- ``serve_torch.py --checkpoint`` serves the checkpoint that
  ``train_torch.py --mesh data=1,model=2`` wrote: the ranks' parameters
  put together, and the tokens of a model loaded with them;
- ``models.convert.shards_for_rank`` cuts JAX's pipelined optax state
  into each stage's optimizer state (``tests/test_torch_gpt_pipeline.py``).

Every comparison is exact.
"""

import dataclasses
import os
import threading

import pytest
import torch

from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch import workloads as tw
from distributedtensorflow_tpu_torch.checkpoint import CheckpointManager
from distributedtensorflow_tpu_torch.checkpoint.manager import group_max
from distributedtensorflow_tpu_torch.data import InputContext, device_put_batch
from distributedtensorflow_tpu_torch.parallel import sharding
from distributedtensorflow_tpu_torch.parallel.mesh import MeshSpec
from distributedtensorflow_tpu_torch.parallel.moe import local_experts
from distributedtensorflow_tpu_torch.parallel.zero import (
    ZeroSharder,
    unchunk_array,
)
from distributedtensorflow_tpu_torch.testing import run_mesh
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401
from distributedtensorflow_tpu_torch.train import (
    TrainState,
    create_sharded_state,
    make_train_step,
)
import serve_torch
import train_torch

BATCH = 8

#: (preset, mesh axes, pipeline schedule, --zero)
LAYOUTS = {"model2": ("gpt_lm", dict(data=1, model=2), "gpipe", False),
           "expert2": ("gpt_moe", dict(data=1, expert=2), "gpipe", False),
           "pipe2_gpipe": ("gpt_lm", dict(data=1, pipe=2), "gpipe", False),
           "pipe2_1f1b": ("gpt_lm", dict(data=1, pipe=2), "1f1b", False),
           "data2_model2_zero": ("gpt_lm", dict(data=2, model=2), "gpipe",
                                 True),
           "data2_pipe2_zero": ("gpt_lm", dict(data=2, pipe=2), "1f1b",
                                True),
           "data2_expert2_zero": ("gpt_moe", dict(data=2, expert=2),
                                  "gpipe", True)}


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _workload(preset, schedule="gpipe"):
    pw = tw.get_workload(preset, test_size=True, global_batch_size=BATCH,
                         pp_schedule=schedule)
    return pw, dataclasses.replace(pw.cfg, dtype=torch.float32)


def _build(pw, cfg, mesh=None, seed=0, zero=False):
    """The preset's state (seeded weights) on ``mesh``, or one process's."""
    wl = pw.for_mesh(mesh)
    model = wl.model_cls(cfg, device="cpu",
                         **({"group": mesh} if mesh is not None
                            and wl.model_takes_group else {}))
    model.load_state_dict(wl.init_params(
        cfg, torch.Generator().manual_seed(seed)))
    if mesh is None:
        return wl, TrainState.create(model, wl.make_optimizer)
    state, _ = create_sharded_state(
        model, wl.make_optimizer, mesh, cfg=cfg, rules=wl.layout,
        zero=ZeroSharder(mesh) if zero else None)
    return wl, state


def _cut(whole: dict, pw, cfg, mesh) -> dict:
    """A rank's pieces of a whole state by name, cut here as
    ``create_sharded_state`` and ``shards_for_rank`` cut them."""
    wl = pw.for_mesh(mesh)
    out = dict(whole)
    if mesh.shape["pipe"] > 1:
        out = tm.convert.pipeline_state(out, cfg, stage=mesh.coords["pipe"],
                                        n_stages=mesh.shape["pipe"])
    if mesh.shape["model"] > 1:
        meta = pw.model_cls(cfg, device="meta")
        rules = {k: v for k, v in sharding.tp_rules(meta, cfg, wl.layout)
                 .items() if k in out}
        out = sharding.shard_state(out, rules, mesh.coords["model"],
                                   mesh.shape["model"])
    if mesh.shape["expert"] > 1:
        stacks = set(sharding.ep_rules(cfg, wl.layout))
        out = {k: local_experts(v, mesh.shape["expert"],
                                mesh.coords["expert"]) if k in stacks else v
               for k, v in out.items()}
    return out


def _grads(pw, cfg, seed):
    gen = torch.Generator().manual_seed(seed)
    return {k: 0.01 * torch.randn(v.shape, generator=gen) for k, v in
            pw.init_params(cfg, torch.Generator().manual_seed(0)).items()}


def _save(state, path, mesh=None):
    mgr = CheckpointManager(path, async_save=False,
                            mesh=None if mesh is None else mesh.world)
    assert mgr.save(int(state.step), state, force=True)
    mgr.wait()
    return torch.load(os.path.join(path, str(state.step), "state.pt"),
                      weights_only=True)


def _assert_same_file(got: dict, ref: dict, chunked: bool = False) -> None:
    assert got["step"] == ref["step"]
    for part in ("params", "model_state"):
        assert list(got[part]) == list(ref[part]), part
        for k, v in ref[part].items():
            assert torch.equal(got[part][k], v), k
    assert got["opt_state"]["param_groups"] == \
        ref["opt_state"]["param_groups"]
    assert got["opt_state"]["state"].keys() == ref["opt_state"]["state"].keys()
    for i, entry in ref["opt_state"]["state"].items():
        saved = got["opt_state"]["state"][i]
        assert saved.keys() == entry.keys(), i
        for k, v in entry.items():
            s = saved[k]
            if chunked and s.dim() == 2 and s.shape != v.shape:
                s = unchunk_array(s, v.shape)
            assert torch.equal(s, v), (i, k)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_split_save_is_one_process_file(name, tmp_path):
    preset, axes, schedule, zero = LAYOUTS[name]
    pw, cfg = _workload(preset, schedule)
    steps = [_grads(pw, cfg, s) for s in (1, 2)]
    _, one = _build(pw, cfg)
    for g in steps:
        one.apply_gradients({k: v.clone() for k, v in g.items()})
    ref = _save(one, str(tmp_path / "one"))
    world = 1
    for n in axes.values():
        world *= n

    def body(rank, mesh):
        _, state = _build(pw, cfg, mesh, zero=zero)
        assert state.placement is not None
        for g in steps:
            cut = _cut(g, pw, cfg, mesh)
            if zero:  # ZeRO's rows sum the replicas' local gradients
                cut = {k: v / mesh.shape["data"] for k, v in cut.items()}
            state.apply_gradients(cut)
        _save(state, str(tmp_path / "split"), mesh)

    run_mesh(body, MeshSpec(**axes), world)
    got = torch.load(str(tmp_path / "split" / "2" / "state.pt"),
                     weights_only=True)
    _assert_same_file(got, ref, chunked=zero)


def test_zero_save_over_pipe_restores_into_one_process(tmp_path):
    """A ZeRO run over ``data=2,pipe=2`` (1F1B) saves each slot as its
    ``(2, chunk)`` view of the whole slot; one process restores it with
    ``restore_latest_zero`` (reported as rechunked from degree 2 to 1):
    the file's parameters, and each slot the saved view unchunked."""
    from distributedtensorflow_tpu_torch.parallel.zero import (
        restore_latest_zero,
    )

    pw, cfg = _workload("gpt_lm", "1f1b")
    steps = [_grads(pw, cfg, s) for s in (1, 2)]

    def body(rank, mesh):
        _, state = _build(pw, cfg, mesh, zero=True)
        for g in steps:
            state.apply_gradients({k: v / 2 for k, v in
                                   _cut(g, pw, cfg, mesh).items()})
        _save(state, str(tmp_path / "zp"), mesh)

    run_mesh(body, MeshSpec(data=2, pipe=2), 4)
    whole = torch.load(str(tmp_path / "zp" / "2" / "state.pt"),
                       weights_only=True)
    _, one = _build(pw, cfg, seed=5)
    mgr = CheckpointManager(str(tmp_path / "zp"))
    assert restore_latest_zero(mgr, one) is one
    assert mgr.last_restore_report["rechunked"] == {"from": 2, "to": 1}
    params = dict(one.model.named_parameters())
    dense = list(whole["params"])
    assert dense == list(params)
    for k, v in whole["params"].items():
        assert torch.equal(params[k].detach(), v), k
    for p, st in one.optimizer.state.items():
        name = next(k for k, q in params.items() if q is p)
        saved = whole["opt_state"]["state"][dense.index(name)]
        for k, v in st.items():
            ref = saved[k] if v.dim() == 0 else unchunk_array(saved[k],
                                                              v.shape)
            assert torch.equal(v, ref), (name, k)
    assert one.step == 2


def _assert_restored(state, whole: dict, pw, cfg, mesh) -> None:
    """``state`` holds its cut of the file's parameters and slots."""
    want = whole["params"] if mesh is None else \
        _cut(whole["params"], pw, cfg, mesh)
    got = dict(state.model.named_parameters())
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k].detach(), v), k
    dense = list(whole["params"])  # one group: the dense order
    for p, st in state.optimizer.state.items():
        name = next(k for k, q in got.items() if q is p)
        saved = whole["opt_state"]["state"][dense.index(name)]
        for k, v in st.items():
            ref = saved[k] if v.dim() == 0 or mesh is None else \
                _cut({name: saved[k]}, pw, cfg, mesh)[name]
            assert torch.equal(v, ref), (name, k)
    assert state.step == whole["step"]


def test_restores_across_layouts(tmp_path):
    """model=2 -> one process and -> pipe=2; one process -> model=2."""
    pw, cfg = _workload("gpt_lm")
    steps = [_grads(pw, cfg, s) for s in (1, 2)]

    def train_save(rank, mesh):
        _, state = _build(pw, cfg, mesh)
        for g in steps:
            state.apply_gradients(_cut(g, pw, cfg, mesh))
        _save(state, str(tmp_path / "model2"), mesh)

    run_mesh(train_save, MeshSpec(data=1, model=2), 2)
    path = str(tmp_path / "model2" / "2" / "state.pt")
    whole = torch.load(path, weights_only=True)

    _, one = _build(pw, cfg, seed=5)
    assert CheckpointManager(str(tmp_path / "model2")).restore_latest(one)
    _assert_restored(one, whole, pw, cfg, None)

    def restore(ck):
        def body(rank, mesh):
            _, state = _build(pw, cfg, mesh, seed=5)
            mgr = CheckpointManager(ck, mesh=mesh.world)
            assert mgr.restore_latest(state) is not None
            _assert_restored(state, whole, pw, cfg, mesh)
        return body

    run_mesh(restore(str(tmp_path / "model2")), MeshSpec(data=1, pipe=2), 2)
    _save(one, str(tmp_path / "one"))
    run_mesh(restore(str(tmp_path / "one")), MeshSpec(data=1, model=2), 2)


@pytest.mark.parametrize("axes,schedule", [
    (dict(data=1, model=2), "gpipe"), (dict(data=1, pipe=2), "1f1b")],
    ids=["model2", "pipe2_1f1b"])
def test_resume_is_bit_exact(axes, schedule, tmp_path, one_thread):
    pw, cfg = _workload("gpt_lm", schedule)
    src = pw.input_fn(InputContext(1, 0, BATCH), 0)
    batches = [next(src) for _ in range(4)]
    world = axes["data"] * axes.get("model", 1) * axes.get("pipe", 1)

    def run(state, wl, mesh, hosts):
        step = make_train_step(wl.loss_fn(state.model, group=mesh),
                               mesh=mesh)
        return [float(step(state, device_put_batch(b, "cpu", mesh))[1]
                      ["loss"]) for b in hosts]

    def body(rank, mesh):
        wl, state = _build(pw, cfg, mesh)
        whole = run(state, wl, mesh, batches)
        final = {k: p.detach().clone()
                 for k, p in state.model.named_parameters()}
        wl, state = _build(pw, cfg, mesh)
        first = run(state, wl, mesh, batches[:2])
        mgr = CheckpointManager(str(tmp_path / "ck"), mesh=mesh.world)
        mgr.save(2, state)  # asynchronous
        mgr.wait()
        group_max(0, mesh.world)  # the chief has committed: a barrier
        wl, fresh = _build(pw, cfg, mesh, seed=1)
        assert mgr.restore_latest(fresh) is not None and fresh.step == 2
        rest = run(fresh, wl, mesh, batches[2:])
        assert first + rest == whole, (first, rest, whole)
        for k, p in fresh.model.named_parameters():
            assert torch.equal(p.detach(), final[k]), k

    run_mesh(body, MeshSpec(**axes), world)


def _main_on_ranks(argv, spec: MeshSpec, world: int):
    """``train_torch.main(argv)`` on each thread rank, the rank's mesh in
    place of the process group that ``bootstrap_mesh`` would start."""
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


def test_serve_loads_a_model2_checkpoint(tmp_path, capsys):
    from distributedtensorflow_tpu_torch.obs.registry import Registry
    from distributedtensorflow_tpu_torch.serve import Engine

    ck = str(tmp_path / "ck")
    argv = ["--workload", "gpt_lm", "--test-size", "--device", "cpu",
            "--steps", "2", "--log-every", "1", "--prefetch-depth", "0",
            "--checkpoint-dir", ck, "--optimizer", "lamb", "--lr", "1e-2",
            "--clipnorm", "1.0"]
    _main_on_ranks(argv + ["--mesh", "data=1,model=2"],
                   MeshSpec(data=1, model=2), 2)
    capsys.readouterr()
    saved = torch.load(os.path.join(ck, "2", "state.pt"), weights_only=True)
    args = serve_torch.parse_args(["--config", "gpt_tiny", "--device", "cpu",
                                   "--checkpoint", ck, "--dtype", "float32"])
    cfg = dataclasses.replace(tm.gpt_tiny(), dtype=torch.float32)
    served = serve_torch.build_model(args, cfg, torch.device("cpu"))
    for k, v in served.state_dict().items():
        assert torch.equal(v, saved["params"][k]), k
    ref = tm.GPTLM(cfg, device="cpu")
    ref.load_state_dict(saved["params"])
    tokens = []
    for model in (served, ref):
        eng = Engine(model, registry=Registry())
        req = eng.submit([5, 9, 2, 7, 5, 9, 2, 7], max_new_tokens=6)
        while not req._done.is_set():
            eng.step()
        tokens.append(req.tokens)
    assert tokens[0] == tokens[1] and len(tokens[0]) == 6
