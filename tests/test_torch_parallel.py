"""The port's mesh, bootstrap and collectives against the JAX package's.

``MeshSpec.resolve``, the cluster resolvers and ``pack_by_size`` are pure
functions: both packages get the same inputs (the resolvers the env
dicts of ``tests/test_bootstrap.py``, the JAX coordinator variables
mapped to torchrun's) and must give the same answers.  The collectives
run for real between ranks as threads of this process, each with its own
gloo group (``testing.run_ranks``); their results are held exactly
against sums and concatenations computed here.  The JAX package is only
called.
"""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtensorflow_tpu.parallel import bootstrap as jax_bootstrap
from distributedtensorflow_tpu.parallel import collectives as jax_coll
from distributedtensorflow_tpu.parallel import mesh as jax_mesh
from distributedtensorflow_tpu_torch.data import (
    current_input_context,
    device_put_batch,
)
from distributedtensorflow_tpu_torch.parallel import bootstrap
from distributedtensorflow_tpu_torch.parallel import collectives as coll
from distributedtensorflow_tpu_torch.parallel import mesh as tmesh
from distributedtensorflow_tpu_torch.testing import run_mesh, run_ranks
from distributedtensorflow_tpu_torch.utils import MetricWriter, ThroughputMeter

# ------------------------------------------------------------------ the mesh

SPECS = [dict(), dict(data=2), dict(data=4), dict(data=3), dict(data=8),
         dict(data=-1, model=2), dict(data=2, fsdp=2, model=2),
         dict(data=-1, fsdp=-1), dict(data=-1, model=3), dict(data=1),
         dict(data=1, pipe=-1), dict(data=2, seq=2, expert=2)]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("spec", range(len(SPECS)))
def test_mesh_spec_resolve_matches_jax(spec, n):
    """The same sizes, or a ValueError from both."""
    kw = SPECS[spec]
    try:
        ref = jax_mesh.MeshSpec(**kw).resolve(n)
    except ValueError:
        with pytest.raises(ValueError):
            tmesh.MeshSpec(**kw).resolve(n)
        return
    assert tmesh.MeshSpec(**kw).resolve(n) == ref


def test_mesh_axes_match_jax_and_other_axes_refuse():
    assert tmesh.CANONICAL_AXES == jax_mesh.CANONICAL_AXES
    assert tmesh.BATCH_AXES == jax_mesh.BATCH_AXES
    assert tmesh.parse_mesh("data=2, model=1") == tmesh.MeshSpec(data=2)
    assert tmesh.parse_mesh(None) is None
    mesh = tmesh.build_mesh(tmesh.MeshSpec())  # no process group: one rank
    assert mesh.group is None and mesh.shape["data"] == 1
    assert tmesh.data_axes(mesh) == ("data", "fsdp")
    assert tmesh.replica_count(mesh) == 1
    # pipe builds its group: the stage is the group rank, and the ring of
    # stages wraps (data=2 outermost: ranks 0-1 hold replica 0's stages;
    # three stages tell the previous stage from the next)
    def stages(rank, mesh):
        return (mesh.coords["pipe"], mesh.pipe_group.rank(),
                mesh.pipe_group.size(), mesh.pipe_prev, mesh.pipe_next,
                coll.group_size(mesh), tmesh.replica_index(mesh))
    for data, pipe in ((2, 2), (1, 3)):
        got = run_mesh(stages, tmesh.MeshSpec(data=data, pipe=pipe),
                       data * pipe)
        assert got == [(s, s, pipe, pipe * d + (s - 1) % pipe,
                        pipe * d + (s + 1) % pipe, data, d)
                       for d in range(data) for s in range(pipe)]
    # seq and expert build their groups: each rank its coordinate, the
    # axis's group over both ranks, the gradient group over seq but not
    # over expert, the batch group over neither
    for axis in ("seq", "expert"):
        def groups(rank, mesh, axis=axis):
            along = getattr(mesh, f"{axis}_group")
            return (mesh.coords[axis], along.size(), along.rank(),
                    coll.group_size(mesh),
                    coll.group_size(mesh.batch_group),
                    tmesh.replica_count(mesh), tmesh.replica_index(mesh))
        got = run_mesh(groups, tmesh.MeshSpec(data=1, **{axis: 2}), 2)
        grad = 2 if axis == "seq" else 1
        assert got == [(r, 2, r, grad, 1, 1, 0) for r in range(2)], axis
    # fsdp is a batch axis; model splits a replica's parameters
    fsdp = run_mesh(lambda r, m: m, tmesh.MeshSpec(data=1, fsdp=2), 2)
    assert [tmesh.replica_index(m) for m in fsdp] == [0, 1]
    model = run_mesh(lambda r, m: m, tmesh.MeshSpec(data=1, model=2), 2)
    assert [m.coords["model"] for m in model] == [0, 1]
    assert {tmesh.replica_count(m) for m in model} == {1}


def test_mesh_coordinates_over_ranks():
    meshes = run_ranks(lambda r, g: tmesh.MeshSpec(data=-1).build(g), 4)
    assert [m.coords["data"] for m in meshes] == [0, 1, 2, 3]
    assert {tmesh.replica_count(m) for m in meshes} == {4}
    assert [tmesh.replica_index(m) for m in meshes] == [0, 1, 2, 3]


# --------------------------------------------------------------- bootstrap


def _torch_env(env):
    """A JAX launch env with torchrun's variables in place of the JAX
    coordinator triple."""
    out = {}
    for k, v in env.items():
        if k == "JAX_COORDINATOR_ADDRESS":
            out["MASTER_ADDR"], out["MASTER_PORT"] = v.rsplit(":", 1)
        elif k == "JAX_COORDINATOR_PORT":
            if "JAX_COORDINATOR_ADDRESS" not in env:
                out["MASTER_PORT"] = v
        elif k == "JAX_NUM_PROCESSES":
            out["WORLD_SIZE"] = v
        elif k == "JAX_PROCESS_ID":
            out["RANK"] = v
        else:
            out[k] = v
    return out


_TF = json.dumps
#: The env dicts of tests/test_bootstrap.py (and a few more edges).
ENVS = [
    {},
    {"JAX_COORDINATOR_ADDRESS": "j0:9", "JAX_NUM_PROCESSES": "4",
     "JAX_PROCESS_ID": "2",
     "TF_CONFIG": _TF({"cluster": {"worker": ["x:1", "y:1"]},
                       "task": {"type": "worker", "index": 0}})},
    {"TF_CONFIG": _TF({"cluster": {"worker": ["x:1", "y:1"]},
                       "task": {"type": "worker", "index": 0}})},
    {"TF_CONFIG": _TF({"cluster": {"chief": ["c:1"], "worker": ["w0:1", "w1:1"],
                                   "ps": ["p0:1"]},
                       "task": {"type": "ps", "index": 0}})},
    {"TF_CONFIG": _TF({"cluster": {"worker": ["w0:1"], "evaluator": ["e0:1"]},
                       "task": {"type": "evaluator", "index": 0}})},
    {"TF_CONFIG": "{}"},
    {"SLURM_PROCID": "3", "SLURM_NTASKS": "4",
     "SLURM_STEP_NODELIST": "node[01-04]"},
    {"SLURM_PROCID": "3", "SLURM_NTASKS": "4",
     "SLURM_STEP_NODELIST": "node[01-04]", "JAX_COORDINATOR_PORT": "999"},
    {"SLURM_PROCID": "3", "SLURM_NTASKS": "4",
     "SLURM_STEP_NODELIST": "node[01-04]", "JAX_COORDINATOR_PORT": "999",
     "JAX_COORDINATOR_ADDRESS": "10.1.2.3:555"},
    {"SLURM_PROCID": "0", "SLURM_NTASKS": "1"},
    {"SLURM_PROCID": "1", "SLURM_NTASKS": "2",
     "SLURM_JOB_NODELIST": "c0c[0-1]n[0-3]"},
    {"SLURM_PROCID": "0", "SLURM_NTASKS": "2", "SLURM_STEP_NODELIST": "n[1-2]"},
    {"SLURM_PROCID": "0", "SLURM_NTASKS": "2", "SLURM_STEP_NODELIST": "n[1-2]",
     "TF_CONFIG": _TF({"cluster": {"worker": ["w:1", "v:1", "u:1"]},
                       "task": {"type": "worker", "index": 2}})},
    {"OMPI_COMM_WORLD_RANK": "1", "OMPI_COMM_WORLD_SIZE": "2",
     "JAX_COORDINATOR_ADDRESS": "10.0.0.1:777"},
    {"OMPI_COMM_WORLD_RANK": "0", "OMPI_COMM_WORLD_SIZE": "2"},
    {"KUBERNETES_SERVICE_HOST": "10.96.0.1", "K8S_NUM_PODS": "4",
     "JOB_COMPLETION_INDEX": "2", "HOSTNAME": "trainer-2-abcde",
     "K8S_HEADLESS_SERVICE": "trainer"},
    {"KUBERNETES_SERVICE_HOST": "10.96.0.1", "K8S_NUM_PODS": "4",
     "JOB_COMPLETION_INDEX": "2", "HOSTNAME": "trainer-2",
     "K8S_HEADLESS_SERVICE": "trainer",
     "JAX_COORDINATOR_ADDRESS": "10.2.3.4:888"},
    {"K8S_NUM_PODS": "4", "HOSTNAME": "t-0"},
    {"KUBERNETES_SERVICE_HOST": "x", "K8S_NUM_PODS": "1", "HOSTNAME": "t-0"},
    {"KUBERNETES_SERVICE_HOST": "x", "K8S_NUM_PODS": "3",
     "HOSTNAME": "bert-mlm-1", "K8S_HEADLESS_SERVICE": "bert-mlm"},
    {"KUBERNETES_SERVICE_HOST": "x", "K8S_NUM_PODS": "3", "HOSTNAME": "bert",
     "K8S_HEADLESS_SERVICE": "bert-mlm"},
    {"KUBERNETES_SERVICE_HOST": "x", "K8S_NUM_PODS": "3",
     "HOSTNAME": "bert-mlm-7", "K8S_HEADLESS_SERVICE": "bert-mlm"},
    {"GCE_INSTANCE_GROUP_HOSTS": "vm-a,vm-b.zone,vm-c", "GCE_TASK_INDEX": "1"},
    {"GCE_INSTANCE_GROUP_HOSTS": "vm-a,vm-b.zone,vm-c", "HOSTNAME": "vm-c"},
    {"GCE_INSTANCE_GROUP_HOSTS": "vm-a,vm-b.zone,vm-c", "HOSTNAME": "other"},
    {"GCE_INSTANCE_GROUP_HOSTS": "vm-a"},
    {"GCE_INSTANCE_GROUP_HOSTS": "vm-a,vm-b", "GCE_TASK_INDEX": "9"},
    {"JAX_COORDINATOR_ADDRESS": "svc-0.svc:12321", "JAX_NUM_PROCESSES": "4",
     "JOB_COMPLETION_INDEX": "3"},
    {"JAX_COORDINATOR_ADDRESS": "vm-a:12321", "JAX_NUM_PROCESSES": "3",
     "GCE_TASK_INDEX": "2"},
    {"JAX_COORDINATOR_ADDRESS": "a:1", "JAX_NUM_PROCESSES": "2",
     "JAX_PROCESS_ID": "5"},
    {"KUBERNETES_SERVICE_HOST": "10.96.0.1", "K8S_NUM_PODS": "2",
     "HOSTNAME": "w-1", "K8S_HEADLESS_SERVICE": "w",
     "GCE_INSTANCE_GROUP_HOSTS": "a,b,c", "GCE_TASK_INDEX": "0"},
    {"K8S_NUM_PODS": "2", "HOSTNAME": "w-1", "K8S_HEADLESS_SERVICE": "w",
     "GCE_INSTANCE_GROUP_HOSTS": "a,b,c", "GCE_TASK_INDEX": "0"},
    {"JAX_COORDINATOR_ADDRESS": "a:1"},
    {"JAX_COORDINATOR_ADDRESS": "a:1", "KUBERNETES_SERVICE_HOST": "x",
     "K8S_NUM_PODS": "2", "HOSTNAME": "w-1", "K8S_HEADLESS_SERVICE": "w"},
    {"SM_HOSTS": _TF(["algo-2", "algo-1", "algo-3"]),
     "SM_CURRENT_HOST": "algo-2"},
    {"SM_HOSTS": '["algo-1"]', "SM_CURRENT_HOST": "algo-1"},
    {"SM_HOSTS": '["a", "b"]', "SM_CURRENT_HOST": "c"},
    {"SM_HOSTS": "not json"},
    {"SM_HOSTS": '"abc"', "SM_CURRENT_HOST": "a"},
    {"SM_HOSTS": '{"a": 1, "b": 2}', "SM_CURRENT_HOST": "a"},
    {"SM_HOSTS": "[1, 2]"},
]

RESOLVERS = ["resolve_cluster", "resolve_slurm", "resolve_mpi",
             "resolve_kubernetes", "resolve_gce", "resolve_sagemaker"]


def _fields(cfg):
    if cfg is None:
        return None
    return (cfg.coordinator_address, cfg.num_processes, cfg.process_id)


@pytest.mark.parametrize("resolver", RESOLVERS)
def test_resolvers_match_jax(resolver):
    """Every env dict through the JAX resolver and the port's (torchrun's
    variables in place of the JAX triple): the same ``ClusterConfig``
    fields, None from both, or a ValueError from both."""
    checked = 0
    for env in ENVS:
        try:
            ref = _fields(getattr(jax_bootstrap, resolver)(env))
        except ValueError:
            with pytest.raises(ValueError):
                getattr(bootstrap, resolver)(_torch_env(env))
            continue
        got = _fields(getattr(bootstrap, resolver)(_torch_env(env)))
        assert got == ref, env
        checked += ref is not None
    assert checked >= 1  # each resolver resolves some env


def test_tf_config_and_nodelist_match_jax():
    for env in ENVS:
        if "TF_CONFIG" in env:
            assert _fields(bootstrap.parse_tf_config(env["TF_CONFIG"])) \
                == _fields(jax_bootstrap.parse_tf_config(env["TF_CONFIG"]))
    for nodes in ("n[001-003,07],login0", "c0c[0-1]n[0-3]", "solo",
                  "a[1-2],b[08-10]"):
        assert bootstrap.expand_nodelist(nodes) \
            == jax_bootstrap.expand_nodelist(nodes)


def test_cloud_tpu_branch_has_no_counterpart():
    """JAX's ``auto`` marker for a Cloud-TPU pod; the port stays local."""
    env = {"TPU_WORKER_HOSTNAMES": "t0,t1"}
    assert jax_bootstrap.resolve_cluster(env).auto
    assert bootstrap.resolve_cluster(env) == bootstrap.ClusterConfig()


def test_local_rank_and_device():
    assert bootstrap.local_rank({"LOCAL_RANK": "3"}) == 3
    assert bootstrap.local_rank({"SLURM_LOCALID": "2"}) == 2
    assert bootstrap.local_rank({"OMPI_COMM_WORLD_LOCAL_RANK": "1"}) == 1
    assert bootstrap.local_rank({}) == 0
    assert bootstrap.local_device("cpu", {"LOCAL_RANK": "3"}).type == "cpu"
    with pytest.raises(RuntimeError, match="no card"):
        bootstrap.local_device("cuda", {"LOCAL_RANK": "0"})


def test_initialize_one_process_and_chief_helpers(tmp_path):
    """A local cluster of one gets a group of one (gloo here), the chief
    helpers answer for it, and ``shutdown`` ends it; the backend is
    named, never guessed."""
    with pytest.raises(ValueError, match="backend"):
        bootstrap.initialize(bootstrap.ClusterConfig(), backend="mpi")
    bootstrap.initialize(bootstrap.ClusterConfig(), backend="gloo")
    try:
        assert torch.distributed.get_backend() == "gloo"
        assert bootstrap.process_count() == 1 and bootstrap.is_chief()
        bootstrap.barrier()
        assert bootstrap.broadcast_from_chief({"a": [1]}) == {"a": [1]}
        mesh = tmesh.build_mesh(tmesh.MeshSpec())
        assert mesh.group is not None and tmesh.replica_count(mesh) == 1
        x = torch.arange(3.0)
        assert torch.equal(coll.all_reduce(x, mesh), x)
    finally:
        bootstrap.shutdown()
    assert not torch.distributed.is_initialized()


# ------------------------------------------------------------- collectives


def test_pack_by_size_matches_jax():
    shapes = [((3, 4), np.float32), ((100,), np.float32), ((7,), np.float16),
              ((2, 2), np.float16), ((64, 64), np.float32), ((1,), np.float32),
              ((5, 5, 5), np.float32)]
    tleaves = [torch.zeros(s, dtype=getattr(torch, np.dtype(d).name))
               for s, d in shapes]
    jleaves = [jnp.zeros(s, d) for s, d in shapes]
    for nbytes in (0, -1, 16, 48, 400, 1000, 20000, 10**9):
        assert coll.pack_by_size(tleaves, nbytes) \
            == jax_coll.pack_by_size(jleaves, nbytes), nbytes


def _rank_tensors(rank):
    g = torch.Generator().manual_seed(rank)
    return {"a": torch.randn(3, 4, generator=g),
            "b": torch.randn(17, generator=g),
            "c": torch.randn(2, 2, generator=g).double()}


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_over_thread_ranks(world):
    """packed_all_reduce (SUM packed and unpacked, MEAN), all_reduce MAX,
    all_gather (tiled and stacked), broadcast and reduce_scatter: each
    rank's result equals the value formed here from every rank's input
    (the sums to fp rounding of the summation order)."""

    def body(rank, group):
        x = _rank_tensors(rank)
        return {
            "packed": coll.packed_all_reduce(
                x, group, options=coll.Options(bytes_per_pack=256)),
            "unpacked": coll.packed_all_reduce(list(x.values()), group),
            "mean": coll.packed_all_reduce(x, group, op=coll.ReduceOp.MEAN),
            "max": coll.all_reduce(x["b"], group, coll.ReduceOp.MAX),
            "tree": coll.tree_all_reduce((x["a"],), group),
            "gather": coll.all_gather(x["b"], group),
            "stack": coll.all_gather(x["a"], group, gather_axis=1,
                                     tiled=False),
            "bcast": coll.broadcast(x["a"], group, src=world - 1),
            "scatter": coll.reduce_scatter(torch.arange(4.0 * world) + rank,
                                           group),
        }

    outs = run_ranks(body, world)
    ins = [_rank_tensors(r) for r in range(world)]
    total = {k: sum(i[k] for i in ins) for k in ins[0]}
    for rank, out in enumerate(outs):
        for k in total:
            torch.testing.assert_close(out["packed"][k], total[k])
            torch.testing.assert_close(out["mean"][k], total[k] / world)
            assert out["packed"][k].dtype == ins[0][k].dtype
        for got, k in zip(out["unpacked"], total):
            torch.testing.assert_close(got, total[k])
        torch.testing.assert_close(out["tree"][0], total["a"])
        assert torch.equal(out["max"],
                           torch.stack([i["b"] for i in ins]).amax(0))
        assert torch.equal(out["gather"], torch.cat([i["b"] for i in ins]))
        assert torch.equal(out["stack"],
                           torch.stack([i["a"] for i in ins], 1))
        assert torch.equal(out["bcast"], ins[-1]["a"])
        full = sum(torch.arange(4.0 * world) + r for r in range(world))
        assert torch.equal(out["scatter"], full[4 * rank:4 * rank + 4])


def test_collective_gradients_over_thread_ranks():
    """The backward of all_reduce (SUM) and of all_gather is the sum of
    every rank's incoming gradient (its own slice of it for the gather):
    with loss_r = sum(w_r * f(x)), dx_r equals the gradient of the sum of
    every rank's loss."""
    world = 3

    def body(rank, group):
        x = (torch.arange(4.0) + rank).requires_grad_()
        w = torch.arange(4.0 * world) * (rank + 1)
        summed = coll.all_reduce(x, group)
        gathered = coll.all_gather(x, group)
        (summed * w[:4]).sum().add((gathered * w).sum()).backward()
        return x.grad

    grads = run_ranks(body, world)
    ws = [torch.arange(4.0 * world) * (r + 1) for r in range(world)]
    for rank, g in enumerate(grads):
        want = sum(w[:4] for w in ws) + sum(w[4 * rank:4 * rank + 4]
                                             for w in ws)
        assert torch.equal(g, want)


def test_share_of_mean():
    assert coll.share_of_mean(5) == 1.0  # one rank
    shares = run_ranks(lambda r, g: (
        coll.share_of_mean(torch.tensor(float(r)), g),
        coll.share_of_mean(6, g)), 4)
    # counts 0, 1, 2, 3: max(c, 1) / 6
    assert [float(s[0]) for s in shares] == pytest.approx(
        [1 / 6, 1 / 6, 2 / 6, 3 / 6], rel=1e-7)
    assert {s[1] for s in shares} == {0.25}


# ------------------------------------------------------------------- input


@pytest.mark.parametrize("world,accum", [(2, 1), (2, 2), (4, 2), (2, 4)])
def test_device_put_batch_holds_each_rank_share_of_each_microbatch(world,
                                                                   accum):
    """Rank r's pipeline holds global rows [r B/N, (r+1) B/N) (JAX's
    rank-major layout); after the exchange its i-th microbatch is the
    r-th 1/N of the global i-th microbatch, JAX's
    ``split_microbatches`` of the global batch, whatever the dtype."""
    b = 8 * world * accum // 2

    def body(rank, group):
        mesh = tmesh.build_mesh(tmesh.MeshSpec(data=world), group)
        ctx = current_input_context(b, mesh)
        assert (ctx.num_input_pipelines, ctx.input_pipeline_id) \
            == (world, rank)
        n = ctx.per_host_batch_size
        rows = np.arange(rank * n, (rank + 1) * n)
        host = {"ids": rows.astype(np.int32)[:, None].repeat(3, 1),
                "x": rows.astype(np.float32)}
        return device_put_batch(host, "cpu", mesh, accum_steps=accum)

    outs = run_ranks(body, world)
    micro = b // accum
    for rank, out in enumerate(outs):
        assert out["ids"].dtype == torch.long and out["x"].dtype == \
            torch.float32
        want = [i * micro + rank * (micro // world) + j
                for i in range(accum) for j in range(micro // world)]
        assert out["x"].tolist() == want
        assert out["ids"][:, 2].tolist() == want


# ----------------------------------------------------------------- metrics


def test_metric_writer_on_the_chief_only_and_rate_per_chip(tmp_path):
    with MetricWriter(str(tmp_path / "chief"), chief=True) as w:
        w.write(1, {"loss": 1.0})
    with MetricWriter(str(tmp_path / "other"), chief=False) as w:
        w.write(1, {"loss": 1.0})
    assert (tmp_path / "chief" / "metrics.jsonl").read_text().strip()
    assert not (tmp_path / "other").exists()
    meter = ThroughputMeter(64, n_chips=4)
    meter.start()
    meter.update()
    rates = meter.rates()
    assert math.isclose(rates["examples_per_sec_per_chip"] * 4,
                        rates["examples_per_sec"])
    assert ThroughputMeter(8).n_chips == 1


@pytest.mark.parametrize("spec,world", [(None, 2),
                                        (tmesh.MeshSpec(data=2, model=2), 4)])
def test_thread_ranks_keep_every_group_until_all_ranks_end(monkeypatch,
                                                           spec, world):
    """A rank whose ``fn`` returns at once (it calls no collective) must
    not drop its group while a peer may still be in gloo's constructor:
    the dropped pair failed the peer's ``connectFullMesh`` with
    "Connection closed by peer" on a busy host.  Every group, the world's
    and a mesh's subgroups, lives until every thread has ended (fake
    groups here, whose deletion is observed)."""
    import gc
    import threading

    from distributedtensorflow_tpu_torch.testing import ranks

    deleted, made = [], []

    class Group:
        def __init__(self, store, rank, size, timeout):
            self._rank, self._size = rank, size
            made.append(1)

        def rank(self):
            return self._rank

        def size(self):
            return self._size

        def __del__(self):
            deleted.append(1)

    monkeypatch.setattr(ranks.dist, "ProcessGroupGloo", Group)
    first_done = threading.Event()

    def fn(rank, *_):
        if rank == 0:
            first_done.set()
            return True
        assert first_done.wait(10)
        for _ in range(20):  # rank 0's thread ends meanwhile
            gc.collect()
            threading.Event().wait(0.01)
        return not deleted

    if spec is None:
        out = run_ranks(fn, world)
    else:
        out = run_mesh(fn, spec, world)
    assert all(out), "a group was dropped while a rank still ran"
    gc.collect()
    assert len(deleted) == len(made) >= world
