"""The bucketed, overlapped gradient sync of the port against JAX's plan
and against the unbucketed step.

``parallel/overlap.py``: the buckets of gpt_tiny's parameters equal the
reference's ``plan_buckets`` on the same shapes (by flax path, at three
bucket sizes); and on two thread ranks the bucketed step (each bucket's
all-reduce, or reduce-scatter under ZeRO, started by the backward's
hooks) gives the unbucketed step's losses and parameters bit for bit
over two steps, with and without ``zero``, recording its dispatches in
``collective_dispatch_seconds{overlapped="1"}``.  One intra-op thread
(the CPU's embedding backward is not bit-repeatable across threads).

Tolerances: bucket membership, losses and parameters exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from distributedtensorflow_tpu.models import GPTLM as JaxGPTLM
from distributedtensorflow_tpu.models import gpt_tiny as jax_gpt_tiny
from distributedtensorflow_tpu.parallel import overlap as jax_overlap
from distributedtensorflow_tpu.parallel.sharding import path_str
from distributedtensorflow_tpu_torch import obs
from distributedtensorflow_tpu_torch import workloads as tw
from distributedtensorflow_tpu_torch.data import InputContext, device_put_batch
from distributedtensorflow_tpu_torch.models import flax_paths
from distributedtensorflow_tpu_torch.parallel import zero
from distributedtensorflow_tpu_torch.parallel.mesh import MeshSpec
from distributedtensorflow_tpu_torch.parallel.overlap import OverlapPlan
from distributedtensorflow_tpu_torch.testing import run_mesh
from distributedtensorflow_tpu_torch.train import TrainState, make_train_step

WL = tw.get_workload("gpt_lm", test_size=True)
WL = dataclasses.replace(WL, cfg=dataclasses.replace(WL.cfg,
                                                     dtype=torch.float32))
INIT = WL.init_params(WL.cfg, torch.Generator().manual_seed(0))


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("bucket_kib", [1, 64, 4096])
def test_buckets_equal_jax_plan(bucket_kib):
    """Each bucket holds the flax paths of the reference's bucket, in the
    reference's order of buckets."""
    shapes = jax.eval_shape(JaxGPTLM(jax_gpt_tiny()).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    ref = [[path_str(leaves[i][0]) for i in b]
           for b in jax_overlap.plan_buckets(shapes, bucket_kib << 10)]
    model = WL.model_cls(WL.cfg, device="meta")
    paths = flax_paths(WL.cfg)
    mesh = type("M", (), {"group": None})()
    plan = OverlapPlan.build(model, mesh, paths=paths,
                             bucket_bytes=bucket_kib << 10)
    got = [["/".join(paths[plan.names[i]]) for i in b] for b in plan.buckets]
    assert got == ref
    assert plan.describe() == {"buckets": len(ref), "coverage": 1.0,
                               "mode": "all_reduce"}
    plan.remove()


def _train(use_zero, bucket_bytes):
    batches = [[next(src) for _ in range(2)] for src in
               (WL.input_fn(InputContext(2, r, 8), 0) for r in range(2))]

    def body(rank, mesh):
        model = WL.model_cls(WL.cfg, device="cpu")
        model.load_state_dict(INIT)
        sharder = zero.ZeroSharder(mesh) if use_zero else None
        state = TrainState.create(model, WL.make_optimizer, mesh,
                                  zero=sharder)
        if bucket_bytes:
            state.overlap = OverlapPlan.build(
                model, mesh, zero=sharder, paths=flax_paths(WL.cfg),
                bucket_bytes=bucket_bytes)
        step = make_train_step(WL.loss_fn(model, group=mesh), mesh=mesh)
        losses = []
        for host in batches[rank]:
            state, m = step(state, device_put_batch(host, "cpu", mesh))
            losses.append(float(m["loss"]))
        buckets = len(state.overlap.buckets) if state.overlap else 0
        return losses, {n: p.detach().clone()
                        for n, p in model.named_parameters()}, buckets

    return run_mesh(body, MeshSpec(data=2), 2)


@pytest.fixture
def fresh_registry():
    """A fresh default registry of the port for the test: the dispatch
    histogram stays out of the registry other tests of this worker
    process read."""
    prev = obs.registry.set_default_registry(obs.registry.Registry())
    yield obs.default_registry()
    obs.registry.set_default_registry(prev)


def _dispatches(registry, op: str) -> int:
    hist = registry.get("collective_dispatch_seconds")
    return 0 if hist is None else int(hist.stats(op=op,
                                                 overlapped="1")["count"])


@pytest.mark.parametrize("use_zero", [False, True])
def test_bucketed_step_equals_unbucketed(use_zero, one_thread,
                                         fresh_registry):
    op = "reduce_scatter" if use_zero else "all_reduce"
    ref = _train(use_zero, 0)
    assert _dispatches(fresh_registry, op) == 0
    got = _train(use_zero, 64 << 10)
    for (losses, params, buckets), (rl, rp, _) in zip(got, ref):
        assert buckets > 2
        assert losses == rl
        for n in rp:
            assert torch.equal(params[n], rp[n]), n
    # every bucket of both ranks' two steps went out once
    assert _dispatches(fresh_registry, op) == 2 * 2 * got[0][2]
