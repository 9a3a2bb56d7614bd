"""Quantised compute inside the pipeline (``--quant`` over ``pipe``)
against the JAX package.

The reference's ``PipelinedGPT`` builds its stages' blocks from the same
``GPTConfig``, ``quant`` included, so a pipelined run at ``quant="int8"``
or ``"fp8"`` quantises every block GEMM as the dense model does.  Here
gpt_tiny in fp32 at each mode, from one JAX ``PipelinedGPT`` init, over
``data=1,pipe=2`` (two thread ranks, one block a stage, 8 microbatches)
under GPipe and 1F1B: the loss and each stage's gradients against JAX's
``pipelined_lm_loss`` gradients on the same mesh of two CPU devices, and
the loss against the port's dense quantised model on the same weights
(JAX's ``params_to_dense``).  Then the sites: a stage's layer ``i``
holds the dense layer ``i``'s quantisation sites, and at
``int8_stochastic`` each microbatch rounds with its own seed (the
step's seed plus the microbatch index), bound before every unit.

Tolerances: losses 1e-5 relative; int8 gradients 2e-3 of each leaf's
max-abs, as ``tests/test_torch_quant.py``'s gpt_tiny step (a code can
round the other way where a quantiser's input differs by an ulp, one
grid step of 1/127 of its channel's absmax); fp8 gradients 1e-2 (an
e4m3 code holds 3 mantissa bits, so a flipped code moves by 1/16 to 1/8
of its own value, about 8x int8's step; the pipeline's stages reach
the quantisers through other fp32 operations than JAX's scan, and the
table's gradient, which sums the embedding's and the head's, flips a
few hundred of 65536 codes by up to 5e-3 of its max).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtensorflow_tpu.models import gpt_tiny as jax_gpt_tiny
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
from distributedtensorflow_tpu.train import engine as jax_engine
from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch import workloads as tw
from distributedtensorflow_tpu_torch.data import device_put_batch
from distributedtensorflow_tpu_torch.models.layers import DropoutKey, QuantDense
from distributedtensorflow_tpu_torch.parallel.mesh import MeshSpec
from distributedtensorflow_tpu_torch.testing import run_mesh
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401
from distributedtensorflow_tpu_torch.train.engine import (
    accumulate_gradients_dp,
)

RTOL = 1e-5
GRAD_TOL = {"int8": 2e-3, "fp8": 1e-2}


def _ids(b=16, s=32, vocab=512, seed=5):
    rng = np.random.default_rng(seed)
    start = rng.integers(0, vocab, size=(b, 1))
    step = rng.integers(1, 7, size=(b, 1))
    return ((start + step * np.arange(s)) % vocab).astype(np.int32)


def _workload(schedule, mode):
    pw = tw.get_workload("gpt_lm", test_size=True, global_batch_size=16,
                         seq_len=32, pp_schedule=schedule, quant=mode)
    return pw, dataclasses.replace(pw.cfg, dtype=torch.float32)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_quantised_pipeline_matches_jax_and_the_dense_model(schedule, mode):
    jcfg = dataclasses.replace(jax_gpt_tiny(), dtype=jnp.float32, quant=mode)
    jmesh = jbuild_mesh(JMeshSpec(data=1, pipe=2), jax.devices()[:2])
    pp = JaxPipelinedGPT(jcfg, jmesh, n_microbatches=8, schedule=schedule)
    params = jax.device_get(pp.init(jax.random.PRNGKey(1))["params"])
    ids = _ids()
    jgrads, jmetrics, _ = jax.jit(
        lambda p: jax_engine.accumulate_gradients(
            jax_pipelined_lm_loss(pp), p, {}, {"input_ids": jnp.asarray(ids)},
            jax.random.PRNGKey(0), 1))(params)
    jgrads, jloss = jax.device_get(jgrads), float(jmetrics["loss"])
    pw, cfg = _workload(schedule, mode)
    assert cfg.quant == mode

    dense = tm.GPTLM(cfg, device="cpu")
    dense.load_state_dict(tm.params_from_flax(
        jax.device_get(jax_params_to_dense(params, jcfg)), cfg))
    with torch.no_grad():
        dense_loss = float(tm.lm_loss(dense)(
            {"input_ids": torch.from_numpy(ids)}, None)[0])
    np.testing.assert_allclose(dense_loss, jloss, rtol=RTOL)

    def body(rank, mesh):
        wl = pw.for_mesh(mesh)
        model = wl.model_cls(cfg, device="cpu")
        assert any(isinstance(m, QuantDense) for m in model.modules())
        shape = {"pipe": mesh.shape["pipe"]}
        model.load_state_dict(tm.convert.shards_for_rank(
            params, cfg, {"pipe": mesh.coords["pipe"]}, shape)["params"])
        grads, metrics = accumulate_gradients_dp(
            wl.loss_fn(model, group=mesh), model,
            device_put_batch({"input_ids": ids}, "cpu", mesh), mesh,
            seed=0, step=0)
        want = tm.convert.shards_for_rank(
            jgrads, cfg, {"pipe": mesh.coords["pipe"]}, shape)["params"]
        return float(metrics["loss"]), grads, want

    for loss, grads, want in run_mesh(body, MeshSpec(data=1, pipe=2), 2):
        np.testing.assert_allclose(loss, jloss, rtol=RTOL)
        np.testing.assert_allclose(loss, dense_loss, rtol=RTOL)
        assert grads.keys() == want.keys()
        for k, ref in want.items():
            ref = ref.numpy()
            np.testing.assert_allclose(grads[k].numpy(), ref, rtol=0,
                                       atol=GRAD_TOL[mode]
                                       * np.abs(ref).max(),
                                       err_msg=k)


def test_stage_sites_and_stochastic_seeds():
    """A stage's quantisation sites are the dense model's for the same
    layer; at ``int8_stochastic`` the schedule binds microbatch ``m``'s
    seed (the step's plus ``m``) before its units run, so every
    microbatch of a stage rounds with its own seed."""
    pw, cfg = _workload("1f1b", "int8_stochastic")
    dense = tm.GPTLM(cfg, device="meta")
    want = {n: m.site for n, m in dense.named_modules()
            if isinstance(m, QuantDense)}

    def body(rank, mesh):
        wl = pw.for_mesh(mesh)
        model = wl.model_cls(cfg, device="cpu")
        model.load_state_dict(wl.init_params(
            cfg, torch.Generator().manual_seed(0)))
        sites = {n: m.site for n, m in model.named_modules()
                 if isinstance(m, QuantDense)}
        seen = []
        layer = model.stochastic_quant[0]
        stage_fn = model._stage_fn

        def spy(chunk, x):
            seen.append(int(layer.seed))
            return stage_fn(chunk, x)

        model._stage_fn = spy
        loss, _ = wl.loss_fn(model, group=mesh)(
            device_put_batch({"input_ids": _ids()}, "cpu", mesh),
            DropoutKey(1000))
        assert torch.isfinite(loss)
        return sites, seen

    for sites, seen in run_mesh(body, MeshSpec(data=1, pipe=2), 2):
        assert sites and all(want[n] == s for n, s in sites.items())
        # 8 microbatches, a forward and a backward unit each
        assert sorted(set(seen)) == [1000 + m for m in range(8)]
        assert len(seen) == 16
