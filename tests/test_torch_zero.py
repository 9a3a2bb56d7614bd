"""ZeRO stage 1 of the port against the JAX package and the replicated step.

``parallel/zero.py``: ``chunk_array``/``unchunk_array`` against the
reference's on numpy; the ``--zero`` step (two thread ranks, gpt_tiny in
fp32) against the replicated data-parallel step on the same batches, for
the preset's AdamW and for AdamW with global-norm clipping and the
bias-norm decay mask (the norm's squares summed over the ranks' rows,
the mask resolved on the whole parameters); and a checkpoint saved at
degree 2 restored at degree 1 and back, each layout held against the
reference's in-memory ``ZeroSharder.chunk_tree``/``unchunk_tree`` (its
own checkpoint restore fails on this JAX, ROADMAP section 3).  The
steps run on one intra-op thread: the CPU's embedding backward is not
bit-repeatable across threads.

Tolerances: chunks exactly; the ZeRO step's losses and parameters
exactly against the replicated step for the preset's AdamW (elementwise,
and a sum of two ranks is one addition either way), 1e-5 (relative; of
each parameter's max-abs) with clipping, whose norm sums its squares by
row and then over the ranks, in another order than by parameter
(AdamW's division by the root of its second moment magnifies that);
restored optimizer slots exactly.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from distributedtensorflow_tpu.parallel import zero as jax_zero
from distributedtensorflow_tpu_torch import workloads as tw
from distributedtensorflow_tpu_torch.checkpoint import CheckpointManager
from distributedtensorflow_tpu_torch.data import InputContext, device_put_batch
from distributedtensorflow_tpu_torch.parallel import zero
from distributedtensorflow_tpu_torch.parallel.mesh import MeshSpec
from distributedtensorflow_tpu_torch.testing import run_mesh
from distributedtensorflow_tpu_torch.train import TrainState, make_train_step
from distributedtensorflow_tpu_torch.train.optimizers import (
    build_optimizer,
    exclude_bias_and_norm_mask,
)


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("shape", [(), (7,), (3, 5), (4, 4, 3)])
@pytest.mark.parametrize("degree", [2, 3])
def test_chunk_and_unchunk_match_jax(shape, degree):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jax_zero.chunk_array(x, degree))
    got = zero.chunk_array(torch.from_numpy(x), degree)
    assert zero.chunk_shape(shape, degree) == jax_zero.chunk_shape(
        shape, degree) == tuple(got.shape)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        zero.unchunk_array(got, shape).numpy(),
        np.asarray(jax_zero.unchunk_array(ref, shape)))


def _workload():
    wl = tw.get_workload("gpt_lm", test_size=True)
    return dataclasses.replace(wl, cfg=dataclasses.replace(
        wl.cfg, dtype=torch.float32))


WL = _workload()
INIT = WL.init_params(WL.cfg, torch.Generator().manual_seed(0))


def _optimizer(kind, model):
    if kind == "preset":
        return WL.make_optimizer
    mask = dict(exclude_bias_and_norm_mask(model.named_parameters()))
    return build_optimizer("adamw", 1e-3, weight_decay=0.1,
                           global_clipnorm=0.5, decay_mask=mask)


def _train(kind, use_zero, steps=2):
    batches = [[next(src) for _ in range(steps)] for src in
               (WL.input_fn(InputContext(2, r, 8), 0) for r in range(2))]

    def body(rank, mesh):
        model = WL.model_cls(WL.cfg, device="cpu")
        model.load_state_dict(INIT)
        sharder = zero.ZeroSharder(mesh) if use_zero else None
        state = TrainState.create(model, _optimizer(kind, model), mesh,
                                  zero=sharder)
        step = make_train_step(WL.loss_fn(model, group=mesh), mesh=mesh)
        losses = []
        for host in batches[rank]:
            state, m = step(state, device_put_batch(host, "cpu", mesh))
            losses.append(float(m["loss"]))
        slots = sum(v.numel() for st in state.optimizer.state.values()
                    for v in st.values() if torch.is_tensor(v) and v.dim())
        return losses, {n: p.detach().clone()
                        for n, p in model.named_parameters()}, slots

    return run_mesh(body, MeshSpec(data=2), 2)


@pytest.mark.parametrize("kind", ["preset", "clip_mask"])
def test_zero_step_equals_replicated_step(kind, one_thread):
    """Two steps at degree 2: every rank's losses and parameters equal the
    replicated step's, and each rank keeps half the optimizer slots."""
    ref = _train(kind, False)
    got = _train(kind, True)
    tol = 0.0 if kind == "preset" else 1e-5
    for (losses, params, slots), (rl, rp, rslots) in zip(got, ref):
        np.testing.assert_allclose(losses, rl, rtol=tol, atol=0)
        for n in rp:
            np.testing.assert_allclose(params[n].numpy(), rp[n].numpy(),
                                       rtol=0, atol=tol * float(
                                           rp[n].abs().max()), err_msg=n)
        assert rslots / 2 <= slots <= rslots / 2 + 2 * len(rp)


def _flax_like(state_dict_slots, names):
    return {n: np.asarray(v) for n, v in zip(names, state_dict_slots)}


def test_cross_degree_restore_against_jax_sharder(tmp_path, one_thread):
    """A degree-2 save holds each slot as its (2, chunk) view, which JAX's
    ``chunk_tree`` of the restored whole slot reproduces; restored at
    degree 1 the slots are JAX's ``unchunk_tree`` of the saved views; an
    unchunked save restores into degree 2 as each rank's row of JAX's
    ``chunk_tree``."""
    ck = str(tmp_path / "ck")
    batches = [[next(WL.input_fn(InputContext(2, r, 8), 0))] for r in
               range(2)]

    def save_zero(rank, mesh):
        model = WL.model_cls(WL.cfg, device="cpu")
        model.load_state_dict(INIT)
        state = TrainState.create(model, WL.make_optimizer, mesh,
                                  zero=zero.ZeroSharder(mesh))
        step = make_train_step(WL.loss_fn(model, group=mesh), mesh=mesh)
        state, _ = step(state, device_put_batch(batches[rank][0], "cpu",
                                                mesh))
        CheckpointManager(ck, async_save=False, mesh=mesh).save(
            1, state, force=True)

    run_mesh(save_zero, MeshSpec(data=2), 2)
    saved = torch.load(f"{ck}/1/state.pt", weights_only=True)["opt_state"]
    names = [n for n, _ in WL.model_cls(WL.cfg, device="meta")
             .named_parameters()]
    model = WL.model_cls(WL.cfg, device="cpu")
    model.load_state_dict(INIT)
    target = TrainState.create(model, WL.make_optimizer)
    mgr = CheckpointManager(ck, async_save=False)
    assert zero.saved_opt_layout(mgr, 1, target) == 2
    _, rechunked = zero.restore_step_zero(mgr, 1, target)
    assert rechunked == {"from": 2, "to": 1}
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("data",))
    sharder = jax_zero.ZeroSharder(jmesh)
    params = {n: np.asarray(p.detach()) for n, p in model.named_parameters()}
    for slot in ("exp_avg", "exp_avg_sq"):
        views = _flax_like([saved["state"][i][slot]
                            for i in range(len(names))], names)
        whole = _flax_like([target.optimizer.state[p][slot]
                            for p in model.parameters()], names)
        back = jax.device_get(sharder.unchunk_tree(views, params))
        chunked = jax.device_get(sharder.chunk_tree(whole))
        for n in names:
            np.testing.assert_array_equal(whole[n], back[n], err_msg=n)
            np.testing.assert_array_equal(views[n], chunked[n], err_msg=n)
    CheckpointManager(ck, async_save=False).save(2, target, force=True)
    assert zero.saved_opt_layout(mgr, 2, target) is None
    whole = {slot: _flax_like([target.optimizer.state[p][slot]
                               for p in model.parameters()], names)
             for slot in ("exp_avg", "exp_avg_sq")}

    def restore_zero(rank, mesh):
        m = WL.model_cls(WL.cfg, device="cpu")
        m.load_state_dict(INIT)
        state = TrainState.create(m, WL.make_optimizer, mesh,
                                  zero=zero.ZeroSharder(mesh))
        mgr = CheckpointManager(ck, async_save=False, mesh=mesh)
        assert zero.restore_latest_zero(mgr, state) is state
        assert mgr.last_restore_report["rechunked"] == {"from": 1, "to": 2}
        for c, p in zip(state.zero.chunks, state.zero.params):
            # the rows the next update starts from: the restored weights'
            assert torch.equal(c, zero.chunk_array(p.detach(), 2)[rank])
        return {slot: [state.optimizer.state[c][slot].clone()
                       for c in state.zero.chunks]
                for slot in ("exp_avg", "exp_avg_sq")}

    for rank, rows in enumerate(run_mesh(restore_zero, MeshSpec(data=2), 2)):
        for slot, vals in rows.items():
            chunked = jax.device_get(sharder.chunk_tree(whole[slot]))
            for n, v in zip(names, vals):
                np.testing.assert_array_equal(v.numpy(), chunked[n][rank],
                                              err_msg=n)
