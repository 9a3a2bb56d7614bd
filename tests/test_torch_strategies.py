"""The port's strategy classes (``strategies.py``) against the JAX
package's, on the CPU.

- The reference's shared conformance body (``tests/test_strategies.py``)
  over all six classes at a world of one rank: the mesh, the replica
  count, ``run``, ``reduce`` and ``scope`` (``MultiWorkerMirroredStrategy``
  starts a real gloo process group of one, shut down after).
- Over 4 thread ranks (each with its own gloo group, no process):
  ``MultiWorkerMirroredStrategy``, ``ParameterServerStrategy`` (model=2)
  and ``TPUStrategy(MeshSpec(data=2, model=2))``, each rank holding its
  replica's rows of one numpy array: ``reduce`` (sum, mean, max, min over
  axis None, 0 and 1) and ``gather`` equal the JAX strategy's over the 8
  virtual CPU devices on the whole array (sharded over its batch axes),
  sums and means within 1e-6 of the same reduction of the absolute
  values (another summation order: its rounding scales with the terms,
  not with a cancelling result), max, min and gathers exactly.
- ``MirroredStrategy`` over 4 thread ranks as two hosts of
  ``LOCAL_WORLD_SIZE`` 2: one replica group a host.
- ``distribute_datasets_from_function``'s context and the ambient mesh
  in a scope; ``shard_dataset`` and ``tfdata_iterator`` (and
  ``experimental_distribute_dataset``) against the JAX ones on one
  duck-typed dataset.
- A mnist_lenet step at test size under ``MirroredStrategy().scope()``:
  a finite loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from distributedtensorflow_tpu import strategies as jst
from distributedtensorflow_tpu.data import input_pipeline as jip
from distributedtensorflow_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from distributedtensorflow_tpu_torch import strategies as pst
from distributedtensorflow_tpu_torch import train as tt
from distributedtensorflow_tpu_torch import workloads as tw
from distributedtensorflow_tpu_torch.data import (
    InputContext,
    current_input_context,
    device_put_batch,
    make_input_fn_dataset,
    shard_dataset,
    tfdata_iterator,
)
from distributedtensorflow_tpu_torch.parallel import bootstrap
from distributedtensorflow_tpu_torch.parallel.mesh import (
    MeshSpec,
    current_mesh,
    replica_count,
    replica_index,
)
from distributedtensorflow_tpu_torch.testing import (
    run_group_ranks,
    two_intra_op_threads,  # noqa: F401
)

RTOL = 1e-6
OPS = ("sum", "mean", "max", "min")
AXES = (None, 0, 1)


def _world_one():
    return [
        ("strategy", lambda: pst.Strategy(device="cpu")),
        ("one_device", lambda: pst.OneDeviceStrategy("cpu")),
        ("mirrored", lambda: pst.MirroredStrategy(device="cpu")),
        ("multi_worker",
         lambda: pst.MultiWorkerMirroredStrategy(backend="gloo",
                                                 device="cpu")),
        ("parameter_server", lambda: pst.ParameterServerStrategy(
            device="cpu")),
        ("tpu", lambda: pst.TPUStrategy(MeshSpec(data=1), device="cpu")),
    ]


@pytest.mark.parametrize("name,make", _world_one(),
                         ids=[n for n, _ in _world_one()])
def test_strategy_conformance(name, make):
    """The reference's shared assertions, at a world of one rank."""
    strat = make()
    try:
        assert strat.mesh.size >= 1
        assert strat.num_replicas_in_sync == \
            strat.mesh.shape["data"] * strat.mesh.shape["fsdp"]
        x = torch.arange(16.0).reshape(8, 2)
        out = strat.run(lambda a: (a * 2).sum(axis=-1), (x,))
        torch.testing.assert_close(out, (x * 2).sum(-1))
        assert float(strat.reduce("sum", out)) == pytest.approx(
            float((x * 2).sum()))
        assert float(strat.reduce("mean", out)) == pytest.approx(
            float((x * 2).sum(-1).mean()))
        assert current_mesh() is None
        with strat.scope() as s:
            assert s is strat and current_mesh() is strat.mesh
            y = strat.run(lambda a: a + 1, (x,))
        assert current_mesh() is None
        torch.testing.assert_close(y, x + 1)
        with pytest.raises(KeyError):
            strat.reduce("median", out)
        assert strat.device == torch.device("cpu")
    finally:
        if name == "multi_worker":
            bootstrap.shutdown()


def test_parameter_server_picks_the_reference_model_axis():
    """The largest divisor of the world at or below half of it, over
    thread worlds of 1-4 ranks (JAX's rule over devices)."""
    for world, want in ((1, 1), (2, 1), (3, 1), (4, 2)):
        def body(rank, group, new_group):
            return pst.ParameterServerStrategy(
                group=group, device="cpu",
                new_group=new_group).mesh.shape["model"]
        assert run_group_ranks(body, world) == [want] * world


def test_mirrored_spans_this_hosts_ranks(monkeypatch):
    """Four thread ranks as two hosts of ``LOCAL_WORLD_SIZE`` 2: each
    host's ranks are one replica group, and a reduce sums over them
    only."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")

    def body(rank, group, new_group):
        strat = pst.MirroredStrategy(group, device="cpu", new_group=new_group)
        return (strat.num_replicas_in_sync, strat.mesh.coords["data"],
                float(strat.reduce("sum", torch.tensor([float(rank)]))))

    assert run_group_ranks(body, 4) == [(2, 0, 1.0), (2, 1, 1.0),
                                        (2, 0, 5.0), (2, 1, 5.0)]


# ------------------------------------------------- 4 thread ranks vs JAX


def _array():
    return np.random.default_rng(3).standard_normal((16, 3)).astype(
        np.float32)


def _jax_results(jstrat, a):
    """JAX's reduce over every op and axis and gather, on ``a`` sharded
    over the strategy's batch axes."""
    arr = jax.device_put(jnp.asarray(a), NamedSharding(
        jstrat.mesh, P(("data", "fsdp"))))
    return ({(op, ax): np.asarray(jstrat.reduce(op, arr, axis=ax))
             for op in OPS for ax in AXES}, np.asarray(jstrat.gather(arr)))


PORT_KINDS = {
    "multi_worker": lambda group, ng: pst.MultiWorkerMirroredStrategy(
        group=group, device="cpu", new_group=ng),
    "parameter_server": lambda group, ng: pst.ParameterServerStrategy(
        2, group, device="cpu", new_group=ng),
    "tpu": lambda group, ng: pst.TPUStrategy(
        MeshSpec(data=2, model=2), group, device="cpu", new_group=ng),
}
JAX_KINDS = {
    "multi_worker": lambda: jst.MultiWorkerMirroredStrategy(),
    "parameter_server": lambda: jst.ParameterServerStrategy(
        model_axis_size=2),
    "tpu": lambda: jst.TPUStrategy(JaxMeshSpec(data=2, model=4)),
}


@pytest.mark.parametrize("kind", sorted(PORT_KINDS))
def test_reduce_and_gather_over_ranks_match_jax(devices, kind):
    a = _array()
    want, want_gather = _jax_results(JAX_KINDS[kind](), a)

    def body(rank, group, new_group):
        strat = PORT_KINDS[kind](group, new_group)
        n, i = replica_count(strat.mesh), replica_index(strat.mesh)
        shard = torch.from_numpy(a[i * 16 // n:(i + 1) * 16 // n].copy())
        return ({(op, ax): strat.reduce(op, shard, axis=ax)
                 for op in OPS for ax in AXES}, strat.gather(shard),
                strat.num_replicas_in_sync)

    for got, gathered, replicas in run_group_ranks(body, 4):
        assert replicas == (4 if kind == "multi_worker" else 2)
        for key, value in want.items():
            assert got[key].shape == value.shape, key
            if key[0] in ("sum", "mean"):
                scale = getattr(np, key[0])(np.abs(a), axis=key[1])
                np.testing.assert_array_less(
                    np.abs(got[key] - value), RTOL * scale + 1e-30,
                    err_msg=str(key))
            else:
                np.testing.assert_array_equal(got[key], value,
                                              err_msg=str(key))
        np.testing.assert_array_equal(gathered, want_gather)


def test_input_context_of_a_scope_over_ranks():
    """Each replica's pipeline: from the strategy's own call, from the
    ambient mesh of its scope, and none outside it."""
    def body(rank, group, new_group):
        strat = pst.TPUStrategy(MeshSpec(data=2, model=2), group,
                                device="cpu", new_group=new_group)
        ctx = strat.distribute_datasets_from_function(
            lambda c: c, global_batch_size=8)
        with strat.scope():
            scoped = current_input_context(8)
            fn_ctx = make_input_fn_dataset(lambda c: c.input_pipeline_id,
                                           8)
        return ctx, scoped, fn_ctx, current_input_context(8)

    for rank, (ctx, scoped, fn_ctx, outside) in enumerate(
            run_group_ranks(body, 4)):
        want = InputContext(2, rank // 2, 8)
        assert ctx == scoped == want and ctx.per_host_batch_size == 4
        assert fn_ctx == (rank // 2, want)
        assert outside == InputContext(1, 0, 8)


class _Dataset:
    """A dataset with ``tf.data``'s two methods the helpers use."""

    def __init__(self, rows):
        self.rows = list(rows)

    def shard(self, n, i):
        return _Dataset(self.rows[i::n])

    def as_numpy_iterator(self):
        for r in self.rows:
            yield {"x": np.asarray(r)}


def test_shard_dataset_and_iterator_match_jax():
    ds = _Dataset(range(11))
    for n in (1, 2, 3):
        for i in range(n):
            got = list(tfdata_iterator(shard_dataset(ds, InputContext(n, i))))
            want = list(jip.tfdata_iterator(jip.shard_dataset(
                ds, jip.InputContext(n, i))))
            assert [b["x"] for b in got] == [b["x"] for b in want]

    def body(rank, group, new_group):
        strat = pst.MultiWorkerMirroredStrategy(group=group, device="cpu",
                                                new_group=new_group)
        return [int(b["x"]) for b in strat.experimental_distribute_dataset(
            ds)]

    assert run_group_ranks(body, 2) == [list(range(0, 11, 2)),
                                        list(range(1, 11, 2))]


def test_lenet_step_under_mirrored_scope():
    strat = pst.MirroredStrategy(device="cpu")
    pw = tw.get_workload("mnist_lenet", test_size=True, global_batch_size=16)
    with strat.scope():
        model = pw.model_cls(pw.cfg, device=strat.device)
        model.load_state_dict(pw.init_params(
            pw.cfg, torch.Generator().manual_seed(0)))
        state = tt.TrainState(0, model, tt.sgd(
            list(model.named_parameters()), 0.05, momentum=0.9))
        step = tt.make_train_step(pw.loss_fn(model))
        batches = strat.distribute_datasets_from_function(
            lambda ctx: pw.input_fn(ctx, 0), global_batch_size=16)
        batch = device_put_batch(next(batches), strat.device)
        assert batch["image"].shape[0] == 16
        state, metrics = strat.run(step, (state, batch))
    loss = float(metrics["loss"])
    assert np.isfinite(loss) and state.step == 1
