"""The port's MPMD stage-per-process pipeline (``parallel/pipeline_mpmd.py``)
against the JAX package's, in one process on the CPU.

- the config's validation, with the reference's messages;
- ``_make_ids`` byte-equal to JAX's;
- each stage from converted JAX parameters at the JAX defaults (hidden 64,
  4 heads, seq 32, fp32) at 2 and 4 stages: the forward, the first and
  middle stages' backward (parameter gradients, and dx on a middle
  stage), the last stage's loss and gradients, and one Adam update of
  JAX's gradients, against JAX's ``_build_stage_fns`` (1e-5 of each
  max-abs; 1e-6 relative for the loss);
- the wire: a port ``_Link`` and a JAX ``_Link`` on the two ends of a
  socket pair swap frames both ways, with CRC;
- whole runs at 2 and 4 stages (the >= 3-stage deadlock regression), 3
  steps, the stages as thread workers of the port's ``Coordinator``, from
  the converted JAX parameters: their losses against an in-process
  emulation that drives JAX's stage functions over the same microbatches
  in the same order (1e-5 relative), and equal to the port's own
  in-process ``reference_run`` bit for bit.

No process is spawned here: ``chip_smoke.py``'s ``hostdist`` phase runs
the stages as processes on the card (the kill, the trace files, the
tools).
"""

import socket
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributedtensorflow_tpu.parallel import pipeline_mpmd as jmp
from distributedtensorflow_tpu_torch.models.convert import (
    mpmd_stage_params_from_flax,
    mpmd_stage_params_to_flax,
)
from distributedtensorflow_tpu_torch.parallel import pipeline_mpmd as pmp
from distributedtensorflow_tpu_torch.parallel.coordinator import Coordinator
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401

ATOL = 1e-5      # of each leaf's max-abs
LOSS_RTOL = 1e-6
RUN_RTOL = 1e-5  # whole runs: three Adam steps apart from JAX's


def _pair(n_stages):
    """The JAX and port configs of one run at the JAX defaults."""
    kw = dict(n_stages=n_stages, n_steps=3, n_microbatches=4,
              microbatch_size=2, num_layers=n_stages)
    return jmp.MPMDConfig(**kw), pmp.MPMDConfig(**kw, device="cpu")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= ATOL, (what, err)


def _tree_close(got: dict, want: dict, prefix=""):
    assert set(got) == set(want), (prefix, set(got) ^ set(want))
    for k in want:
        if isinstance(want[k], dict):
            _tree_close(got[k], want[k], f"{prefix}/{k}")
        else:
            _close(got[k], want[k], f"{prefix}/{k}")


def _port_grads(stage, grads):
    return mpmd_stage_params_to_flax(
        {n: g for (n, _), g in zip(stage.model.named_parameters(), grads)})


def _port_params(stage):
    return mpmd_stage_params_to_flax(dict(stage.model.named_parameters()))


def test_config_validation_matches_jax():
    for kw, match in (({"n_stages": 1}, "n_stages"),
                      ({"n_stages": 2, "num_layers": 3}, "divisible"),
                      ({"window": 0}, "window"),
                      ({"hidden_size": 66}, "num_heads")):
        msgs = []
        for cls in (jmp.MPMDConfig, pmp.MPMDConfig):
            with pytest.raises(ValueError, match=match) as e:
                cls(**kw).validate()
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    pmp.MPMDConfig().validate()
    assert pmp.MPMDConfig().device == "cuda"


@pytest.mark.parametrize("step,micro", [(0, 0), (3, 2), (17, 5)])
def test_make_ids_is_byte_equal_to_jax(step, micro):
    for cfg in (dict(), dict(seed=3, vocab_size=50257, seq_len=64,
                             microbatch_size=3)):
        want = jmp._make_ids(jmp.MPMDConfig(**cfg), step, micro)
        got = pmp._make_ids(pmp.MPMDConfig(**cfg), step, micro)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_stage_converter_round_trips_and_names():
    jcfg, pcfg = _pair(2)
    for sid in (0, 1):
        params = _np_tree(jmp._build_stage_fns(jcfg, sid)[0])
        state = mpmd_stage_params_from_flax(params)
        assert {k: tuple(v.shape) for k, v in state.items()} == \
            pmp.stage_shapes(pcfg, sid)
        back = mpmd_stage_params_to_flax(state)
        jax.tree.map(np.testing.assert_array_equal, back, params)
    assert "head.weight" in state and state["head.weight"].shape == (256, 64)
    assert set(pmp.init_stage_state(pcfg, 1)) == set(state)
    for n_stages in (2, 4):
        cfg = pmp.MPMDConfig(n_stages=n_stages, num_layers=4, device="cpu")
        for sid in range(n_stages):
            model = pmp.StageModel(cfg, sid, device="cpu")
            assert list(pmp.stage_shapes(cfg, sid).items()) == [
                (k, tuple(t.shape)) for k, t in model.state_dict().items()]


@pytest.mark.parametrize("n_stages", [2, 4])
def test_each_stage_matches_jax(n_stages):
    """Forward, backward, loss and one Adam step of every stage from the
    same converted parameters and inputs."""
    jcfg, pcfg = _pair(n_stages)
    rng = np.random.default_rng(1)
    ids = pmp._make_ids(pcfg, 0, 0)
    x = rng.standard_normal((2, 32, 64)).astype(np.float32)
    dy = rng.standard_normal((2, 32, 64)).astype(np.float32)
    for sid in range(n_stages):
        params, opt, fwd, bwd, loss_grad, update = jmp._build_stage_fns(
            jcfg, sid)
        stage = pmp.Stage(pcfg, sid,
                          mpmd_stage_params_from_flax(_np_tree(params)))
        inp = ids if sid == 0 else x
        _close(stage.forward(stage.input(inp)).numpy(),
               fwd(params, jnp.asarray(inp)), f"stage {sid} forward")
        if sid == n_stages - 1:
            loss, (gp, dx) = loss_grad(params, jnp.asarray(x),
                                       jnp.asarray(ids))
            ploss, pgp, pdx = stage.loss_grad(stage.input(x),
                                              stage.input(ids))
            assert abs(float(ploss) - float(loss)) <= LOSS_RTOL * abs(
                float(loss))
        elif sid == 0:
            gp = bwd(params, jnp.asarray(ids), jnp.asarray(dy))
            pgp, pdx, dx = stage.backward(stage.input(ids),
                                          stage.input(dy)), None, None
        else:
            gp, dx = bwd(params, jnp.asarray(x), jnp.asarray(dy))
            pgp, pdx = stage.backward(stage.input(x), stage.input(dy))
        _tree_close(_port_grads(stage, pgp), _np_tree(gp))
        if dx is not None:
            _close(pdx.numpy(), dx, f"stage {sid} dx")
        # one Adam update from JAX's gradients of 4 microbatches on both
        # sides (Adam's first step divides a gradient by its own size, so
        # the update of a tiny entry would carry the gradients' rounding)
        new_params, _ = update(params, opt,
                               jax.tree.map(lambda g: g * 0.25, gp))
        named = mpmd_stage_params_from_flax(_np_tree(gp))
        stage.update([named[n] for n, _ in stage.model.named_parameters()],
                     0.25)
        _tree_close(_port_params(stage), _np_tree(new_params))


def test_links_of_both_packages_share_one_wire():
    """A port ``_Link`` on one end of a socket pair and a JAX ``_Link`` on
    the other swap activation and cotangent frames (CRC on), the trace
    context in the header, both ways."""
    a, b = socket.socketpair()
    port = pmp._Link(a, "port", crc=True)
    ref = jmp._Link(b, "jax", crc=True)
    try:
        rng = np.random.default_rng(2)
        act = {"x": rng.standard_normal((2, 8, 16)).astype(np.float32),
               "ids": np.arange(16, dtype=np.int32).reshape(2, 8),
               "step": np.int32(3), "micro": np.int32(1),
               "t_send": np.float64(12.5)}
        trace = {"trace_id": "t" * 16, "span_id": "s" * 8}
        port.send(act, trace=trace)
        got, tr = ref.recv(10.0)
        assert tr == trace and set(got) == set(act)
        for k, v in act.items():
            assert np.asarray(got[k]).tobytes() == np.asarray(v).tobytes()
        cot = {"dx": rng.standard_normal((2, 8, 16)).astype(np.float32),
               "step": np.int32(3), "micro": np.int32(1),
               "t_send": np.float64(13.0)}
        ref.send(cot, trace=tr)
        got, tr2 = port.recv(10.0)
        assert tr2 == trace
        for k, v in cot.items():
            assert np.asarray(got[k]).tobytes() == np.asarray(v).tobytes()
        assert port.poll(0.0) is None
    finally:
        port.close()
        ref.close()


def test_severed_link_raises_worker_unavailable():
    a, b = socket.socketpair()
    link = pmp._Link(a, "port", crc=True)
    b.close()
    with pytest.raises(pmp.WorkerUnavailableError, match="severed"):
        link.recv(10.0)
    link.close()


def _jax_emulation(jcfg, stage_params):
    """JAX's stage functions driven in one process, the pipeline's order:
    each microbatch down the stages, the last stage's loss and backward,
    the cotangents back up; gradients summed in microbatch order, each
    stage's Adam step on their mean."""
    fns = [jmp._build_stage_fns(jcfg, i) for i in range(jcfg.n_stages)]
    params = list(stage_params)
    opts = [f[1] for f in fns]
    losses = []
    for step in range(jcfg.n_steps):
        grads = [None] * jcfg.n_stages
        step_losses = []
        for micro in range(jcfg.n_microbatches):
            ids = jnp.asarray(jmp._make_ids(jcfg, step, micro))
            xs = [ids]
            for i in range(jcfg.n_stages - 1):
                xs.append(jnp.asarray(np.asarray(fns[i][2](params[i],
                                                           xs[-1]))))
            loss, (gp, dx) = fns[-1][4](params[-1], xs[-1], ids)
            grads[-1] = jmp._grads_add(grads[-1], gp)
            step_losses.append(float(loss))
            for i in range(jcfg.n_stages - 2, -1, -1):
                if i == 0:
                    grads[0] = jmp._grads_add(
                        grads[0], fns[0][3](params[0], xs[0], dx))
                else:
                    gp, dx = fns[i][3](params[i], xs[i], dx)
                    grads[i] = jmp._grads_add(grads[i], gp)
        for i, f in enumerate(fns):
            g = jax.tree.map(lambda t: t * (1.0 / jcfg.n_microbatches),
                             grads[i])
            params[i], opts[i] = f[5](params[i], opts[i], g)
        losses.append(float(np.mean(step_losses)))
    return losses


@pytest.mark.parametrize("n_stages", [2, 4])
def test_threaded_run_matches_the_jax_emulation(n_stages, monkeypatch):
    jcfg, pcfg = _pair(n_stages)
    params = [jmp._build_stage_fns(jcfg, i)[0] for i in range(n_stages)]
    states = [mpmd_stage_params_from_flax(_np_tree(p)) for p in params]
    monkeypatch.setattr(pmp, "_initial_state",
                        lambda cfg, sid: states[sid])
    with tempfile.TemporaryDirectory() as logdir, \
            Coordinator(num_workers=n_stages) as coord:
        out = pmp.run_mpmd_pipeline(pcfg, logdir, coordinator=coord,
                                    join_timeout_s=240)
        rows = [open(f"{logdir}/stage{i}/metrics.jsonl").read().splitlines()
                for i in range(n_stages)]
    want = _jax_emulation(jcfg, params)
    assert len(out["losses"]) == 3 and out["stages"] == n_stages
    np.testing.assert_allclose(out["losses"], want, rtol=RUN_RTOL)
    assert out["losses"] == pmp.reference_run(pcfg, states)[0]
    assert [r["stage"] for r in out["stage_results"]] == list(
        range(n_stages))
    assert all(len(r) == 3 for r in rows)
