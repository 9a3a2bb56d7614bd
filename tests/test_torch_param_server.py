"""The port's async parameter server (``parallel/param_server.py``) and
``train_torch.py``'s ``--job`` routing against the JAX package's.

Placement: ``partition_params`` of both packages on one dict of named
numpy arrays gives the same plan JSON and the same shards, and each
package reads the other's plan.  The wire is the reference's byte for
byte: a JAX ``AsyncPSClient`` drives a port ``PSServer`` and a port
client a JAX server, and the same pulls and pushes (one of them stale)
give the same parameters (1e-6), versions, staleness histograms and
per-worker counts in every pairing; pushes with keys that are not the
shard's are refused.  A workload with buffers (BatchNorm's running
statistics) is refused with the reference's message.  One worker (a
thread, ``device="cpu"``) equals the sequential SGD replay within 1e-5,
and, from converted Wide&Deep weights in fp32 with the preset's
Adagrad, JAX's own async worker within 1e-5 (losses and parameters); two
workers in threads advance the version workers x ps x steps.
``serve_until``'s startup grace outlives its idle timeout, and a wedged
peer cannot pin it past the drain cap.  ``build_cluster_pieces`` is
byte-identical across calls.  ``train_torch.main`` routes a TF_CONFIG
cluster with a ``ps`` job (and an ``evaluator`` task) before any process
group starts, and a 1 ps + chief + worker cluster runs to its push
budget with its tasks as threads.  No test spawns a process: the
``AsyncPSTrainer``'s worker processes run in ``chip_smoke.py``'s ``jobs``
phase on the card.
"""

import ast
import dataclasses
import itertools
import os
import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import train_torch
from distributedtensorflow_tpu import workloads as jax_workloads
from distributedtensorflow_tpu.data.service import (
    encode_batch as jax_encode_batch,
)
from distributedtensorflow_tpu.parallel import param_server as jps
from distributedtensorflow_tpu.parallel import sharding as jsharding
from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch import workloads as tw
from distributedtensorflow_tpu_torch.data import InputContext, device_put_batch
from distributedtensorflow_tpu_torch.data.service import encode_batch
from distributedtensorflow_tpu_torch.parallel import bootstrap
from distributedtensorflow_tpu_torch.parallel import param_server as pps
from distributedtensorflow_tpu_torch.parallel import sharding as psharding
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401
from distributedtensorflow_tpu_torch.train import sgd
from distributedtensorflow_tpu_torch.train.engine import dropout_keys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": (jps, jsharding), "port": (pps, psharding)}
ENCODE = {"jax": jax_encode_batch, "port": encode_batch}
SGD = {"jax": lambda: optax.sgd(0.5),
       "port": lambda named: sgd(named, 0.5)}
WIDEDEEP = {"workload": "widedeep", "batch_size": 16, "test_size": True,
            "seed": 0, "device": "cpu"}


def _toy_params():
    rng = np.random.default_rng(0)
    return {
        "embed_0/embedding": rng.standard_normal((64, 8)).astype(np.float32),
        "big/kernel": rng.standard_normal((300, 64)).astype(np.float32),
        "mlp_0/kernel": rng.standard_normal((16, 4)).astype(np.float32),
        "mlp_0/bias": np.zeros((4,), np.float32),
    }


def _partitioners(pkg):
    s = PACKAGES[pkg][1]
    return {"none": None, "fixed2": s.FixedShardsPartitioner(2),
            "fixed3": s.FixedShardsPartitioner(3),
            "min1m": s.MinSizePartitioner(min_shard_bytes=1 << 20),
            "min16k": s.MinSizePartitioner(min_shard_bytes=16 << 10)}


# --- placement --------------------------------------------------------------


@pytest.mark.parametrize("num_ps", [1, 2, 3])
@pytest.mark.parametrize("part", ["none", "fixed2", "fixed3", "min1m",
                                  "min16k"])
def test_partition_matches_jax(num_ps, part):
    flat = _toy_params()
    jshards, jplan = jps.partition_params(flat, num_ps,
                                          _partitioners("jax")[part])
    shards, plan = pps.partition_params(flat, num_ps,
                                        _partitioners("port")[part])
    assert plan.to_json() == jplan.to_json()
    assert [sorted(s) for s in shards] == [sorted(s) for s in jshards]
    for s, js in zip(shards, jshards):
        for k in js:
            np.testing.assert_array_equal(s[k], js[k])
    # each package reads the other's plan; reassembly is lossless
    assert pps.PlacementPlan.from_json(jplan.to_json()) == plan
    assert jps.PlacementPlan.from_json(plan.to_json()) == jplan
    out = pps.reassemble(plan, shards)
    for k in flat:
        np.testing.assert_array_equal(out[k], flat[k])
    grads = {k: np.ones_like(v) for k, v in flat.items()}
    assert [sorted(d) for d in pps.split_like(plan, grads)] == \
        [sorted(d) for d in jps.split_like(jplan, grads)]


def test_build_cluster_pieces_is_byte_identical():
    """Every task derives the same shards and plan from the same flags."""
    part = psharding.MinSizePartitioner(min_shard_bytes=1 << 10)
    spec = {**WIDEDEEP, "steps": 1}
    runs = [pps.build_cluster_pieces(spec, 2, 2, part) for _ in range(2)]
    (_, a, pa, _), (_, b, pb, _) = runs
    assert pa.to_json() == pb.to_json()
    assert any(len(v) > 1 for v in pa.pieces.values())  # rows were split
    for sa, sb in zip(a, b):
        assert sa.keys() == sb.keys()
        for k in sa:
            assert sa[k].tobytes() == sb[k].tobytes(), k
    names = {n for n, _ in tw.get_workload("widedeep", test_size=True)
             .model_cls(tw.widedeep_test_config(), device="meta")
             .named_parameters()}
    assert set(pa.pieces) == names  # the port's state_dict names


def test_mutable_collections_rejected_as_jax():
    spec = {**WIDEDEEP, "workload": "cifar_resnet20", "steps": 1}
    with pytest.raises(ValueError) as jerr:
        jps.build_cluster_pieces(spec, 2, 1)
    with pytest.raises(ValueError, match="batch_stats") as err:
        pps.build_cluster_pieces(spec, 2, 1)
    assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="params-only"):
        pps.AsyncPSTrainer("cifar_resnet20", num_workers=1, steps=1,
                           device="cpu")


# --- the wire, both ways ----------------------------------------------------


def _session(client_pkg, server_pkg):
    """Two clients of ``client_pkg`` against two servers of
    ``server_pkg``: pulls, a fresh push, a stale push, a refused push."""
    flat = _toy_params()
    shards, plan = PACKAGES[server_pkg][0].partition_params(
        flat, 2, _partitioners(server_pkg)["fixed2"])
    servers = [PACKAGES[server_pkg][0].PSServer(s, SGD[server_pkg])
               for s in shards]
    c = PACKAGES[client_pkg][0]
    cplan = c.PlacementPlan.from_json(plan.to_json())
    addrs = [s.address for s in servers]
    rng = np.random.default_rng(1)
    try:
        a = c.AsyncPSClient(addrs, cplan, worker_id=0)
        b = c.AsyncPSClient(addrs, cplan, worker_id=1)
        pulled, va = a.pull()
        _, vb = b.pull()
        ga = {k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in flat.items()}
        gb = {k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in flat.items()}
        sa = a.push(ga, va)
        sb = b.push(gb, vb)  # b pulled before a's push: one version stale
        # a shard whose keys are not the server's is refused by it, and
        # the client raises before sending a tree of unknown keys
        bad = {k + "_nope": v for k, v in c.split_like(cplan, ga)[0].items()}
        header, _ = a._rpc(0, {"op": "push", "pulled_version": va[0],
                               "worker": 0}, ENCODE[client_pkg](bad))
        assert "do not match shard keys" in header["error"]
        with pytest.raises(KeyError):
            a.push({k + "_nope": v for k, v in ga.items()}, va)
        after, versions = c.AsyncPSClient(addrs, cplan).pull()
        stats = [{k: v for k, v in st.items()}
                 for st in c.AsyncPSClient(addrs, cplan).stats()]
    finally:
        for s in servers:
            s.stop()
    for k in flat:
        np.testing.assert_array_equal(pulled[k], flat[k])
    return after, versions, (va, vb, sa, sb), stats


@pytest.mark.parametrize("client,server", list(itertools.product(
    PACKAGES, PACKAGES)))
def test_wire_interoperates_both_ways(client, server):
    ref = _session("jax", "jax")
    got = _session(client, server)
    for k in ref[0]:
        np.testing.assert_allclose(got[0][k], ref[0][k], rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    assert got[1:] == ref[1:]
    assert got[2][3]["staleness"] == [1, 1]
    assert got[3][0]["staleness_hist"] == {"0": 1, "1": 1}


def test_concurrent_pushes_lose_no_update():
    """16 client threads push 5 times each into one shard at once, with
    a short switch interval: the version counts every push, the
    staleness histogram sums to them, and SGD's sum of the (constant)
    gradients lands whole (a lost update would leave a step out)."""
    import sys

    flat = _toy_params()
    server = pps.PSServer(flat, SGD["port"])
    plan = pps.partition_params(flat, 1)[1]
    grads = {k: np.full_like(v, 1.0 / 64) for k, v in flat.items()}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    errors = []

    def pushes(i):
        try:
            client = pps.AsyncPSClient([server.address], plan, worker_id=i)
            for _ in range(5):
                client.push(grads, client.pull()[1])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    try:
        threads = [threading.Thread(target=pushes, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads) and not errors
        stats = pps.AsyncPSClient([server.address], plan).stats()[0]
        assert stats["version"] == 80
        assert sum(stats["staleness_hist"].values()) == 80
        assert stats["pushes_by_worker"] == {str(i): 5 for i in range(16)}
        for k, v in server.params().items():
            np.testing.assert_allclose(v, flat[k] - 0.5 * 80 / 64,
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    finally:
        sys.setswitchinterval(interval)
        server.stop()


# --- workers ----------------------------------------------------------------


def _cluster(spec, num_ps, num_workers, make_optimizer=None, part=None):
    _, shards, plan, mk = pps.build_cluster_pieces(
        spec, num_ps, num_workers, part, make_optimizer)
    servers = [pps.PSServer(s, mk) for s in shards]
    return servers, [s.address for s in servers], plan


def test_one_worker_equals_sequential_sgd():
    steps = 5
    spec = {**WIDEDEEP, "steps": steps}
    servers, addrs, plan = _cluster(
        spec, 2, 1, lambda named: sgd(named, 0.1),
        psharding.FixedShardsPartitioner(2))
    try:
        out = {}
        t = threading.Thread(target=lambda: out.update(
            r=pps.worker_loop(0, 1, addrs, plan, spec)))
        t.start()
        t.join(timeout=120)
        losses, staleness = out["r"]
        assert staleness == [0] * (2 * steps)
        async_params = pps.AsyncPSClient(addrs, plan).pull()[0]
    finally:
        for s in servers:
            s.stop()

    wl = tw.get_workload("widedeep", test_size=True, global_batch_size=16)
    model = wl.model_cls(wl.cfg, device="cpu")
    model.load_state_dict(wl.init_params(wl.cfg,
                                         torch.Generator().manual_seed(0)))
    opt = sgd(list(model.named_parameters()), 0.1)
    loss_fn = wl.loss_fn(model)
    data = wl.input_fn(InputContext(1, 0, 16), 0)
    seq = []
    for step in range(steps):
        key, = dropout_keys(1000, step, 1)
        loss, _ = loss_fn(device_put_batch(next(data), "cpu"), key)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        seq.append(float(loss.detach()))
    np.testing.assert_allclose(losses, seq, rtol=1e-5)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(async_params[n], p.detach().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


def test_one_worker_matches_jax_async_worker(monkeypatch):
    """JAX's worker and the port's, each against its own PS pair, from
    the same Wide&Deep weights (fp32) with the preset's Adagrad."""
    steps, batch = 4, 16
    fp32 = jax_workloads.widedeep_test_config
    monkeypatch.setattr(jax_workloads, "widedeep_test_config",
                        lambda: dataclasses.replace(fp32(),
                                                    dtype=jnp.float32))
    jw = jax_workloads.get_workload("widedeep", test_size=True,
                                    global_batch_size=batch)
    variables = jax.device_get(jw.init_fn(jax.random.PRNGKey(0)))
    jflat = jps._flatten(variables["params"])
    cfg = tw.widedeep_test_config()
    state = tm.params_from_flax(variables, cfg)
    pw = tw.get_workload("widedeep", test_size=True, global_batch_size=batch)
    spec = {"workload": "widedeep", "batch_size": batch, "test_size": True,
            "seed": 0, "steps": steps}
    runs = {}
    for pkg, flat, make in (
            ("jax", jflat, jw.make_optimizer),
            ("port", {k: v.numpy() for k, v in state.items()},
             pw.make_optimizer)):
        mod = PACKAGES[pkg][0]
        shards, plan = mod.partition_params(
            flat, 2, _partitioners(pkg)["fixed2"])
        servers = [mod.PSServer(s, make) for s in shards]
        addrs = [s.address for s in servers]
        extra = {"device": "cpu", "dtype": "float32"} if pkg == "port" \
            else {}
        try:
            losses, _ = mod.worker_loop(0, 1, addrs, plan, {**spec, **extra})
            runs[pkg] = (losses, mod.AsyncPSClient(addrs, plan).pull()[0])
        finally:
            for s in servers:
                s.stop()
    np.testing.assert_allclose(runs["port"][0], runs["jax"][0], rtol=1e-5)
    back = tm.params_to_flax({k: torch.from_numpy(v)
                              for k, v in runs["port"][1].items()}, cfg)
    got = jps._flatten(back["params"])
    for k, v in runs["jax"][1].items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_two_workers_advance_the_version_workers_x_ps_x_steps():
    steps = 3
    trainer = pps.AsyncPSTrainer(
        "widedeep", num_ps=2, num_workers=2, steps=steps, batch_size=16,
        partitioner=psharding.FixedShardsPartitioner(2), device="cpu")
    with trainer:
        out = {}
        threads = [threading.Thread(target=lambda i=i: out.update({
            i: pps.worker_loop(i, 2, trainer._addrs, trainer._plan,
                               trainer._spec)})) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert sorted(out) == [0, 1]
        assert trainer.global_version() == 2 * 2 * steps
        stats = trainer.ps_stats()
        assert [sum(s["staleness_hist"].values()) for s in stats] == \
            [2 * steps, 2 * steps]
        assert all(s["pushes_by_worker"] == {"0": steps, "1": steps}
                   for s in stats)
        assert all(len(st) == 2 * steps for _, st in out.values())
        params = trainer.current_params()
        assert set(params) == set(trainer._plan.pieces)
        metrics = trainer.evaluate(batches=2)
        assert set(metrics) == {"accuracy", "log_loss"}
        assert all(np.isfinite(v) for v in metrics.values())
        trainer.join(timeout=1)  # no worker process was started
        assert np.isnan(trainer.first_last_mean_loss()[0])


def test_worker_without_a_card_raises(monkeypatch):
    """Workers compute on --device, cuda by default: no fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pps.worker_loop(0, 1, [], pps.PlacementPlan(0, {}),
                        {**WIDEDEEP, "device": "cuda", "steps": 1})


# --- serve_until -------------------------------------------------------------


def test_serve_until_startup_grace_outlives_idle_timeout():
    server = pps.PSServer({}, SGD["port"], port=0)
    out = {}

    def run():
        t0 = time.monotonic()
        out["version"] = server.serve_until(
            None, idle_timeout_s=0.2, startup_grace_s=1.5, poll_s=0.05)
        out["elapsed"] = time.monotonic() - t0

    th = threading.Thread(target=run, daemon=True)
    try:
        th.start()
        time.sleep(0.6)  # far past the idle timeout: no push yet
        assert th.is_alive(), "ps task idled out during the startup grace"
        th.join(timeout=10)
        assert not th.is_alive()
        assert out["version"] == 0 and out["elapsed"] >= 1.4, out
    finally:
        server.stop()


def test_wedged_peer_cannot_pin_serve_until():
    server = pps.PSServer(_toy_params(), SGD["port"])
    try:
        wedge = socket.create_connection(("127.0.0.1", server.port))
        time.sleep(0.3)  # the handler is in its blocking receive
        t0 = time.monotonic()
        assert server.serve_until(0, poll_s=0.01) == 0
        assert time.monotonic() - t0 < pps._DRAIN_CAP_S + 2.0
        wedge.close()
    finally:
        server.stop()


# --- train_torch.py's roles --------------------------------------------------


FLAGS = ("--job", "--num-ps", "--num-workers", "--poll-interval",
         "--max-evaluations", "--idle-timeout")


def _train_py_flags() -> dict:
    """train.py's add_argument calls of FLAGS: choices, default, help and
    type, read from its source."""
    tree = ast.parse(open(os.path.join(REPO, "train.py")).read())
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "add_argument" and node.args
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value in FLAGS):
            kw = {k.arg: (k.value.id if isinstance(k.value, ast.Name)
                          else ast.literal_eval(k.value))
                  for k in node.keywords}
            out[node.args[0].value] = kw
    return out


def test_job_flags_take_train_py_choices_defaults_and_help():
    ref = _train_py_flags()
    assert sorted(ref) == sorted(FLAGS)
    actions = {a.option_strings[0]: a
               for a in train_torch.build_parser()._actions
               if a.option_strings}
    for flag, kw in ref.items():
        a = actions[flag]
        assert a.default == kw.get("default"), flag
        assert a.help == kw["help"], flag
        assert tuple(a.choices or ()) == tuple(kw.get("choices", ())), flag
        assert (a.type.__name__ if a.type else None) == kw.get("type"), flag


CLUSTER = {"ps": ["127.0.0.1:1", "127.0.0.1:2"], "chief": ["127.0.0.1:3"],
           "worker": ["127.0.0.1:4"]}


@pytest.mark.parametrize("tf_config,job", [
    ({"cluster": CLUSTER, "task": {"type": "worker", "index": 0}},
     ("ps-cluster", (CLUSTER, "worker", 0))),
    ({"cluster": CLUSTER, "task": {"type": "ps", "index": 1}},
     ("ps-cluster", (CLUSTER, "ps", 1))),
    ({"cluster": {"worker": ["a:1"], "evaluator": ["a:2"]},
      "task": {"type": "evaluator", "index": 0}}, ("evaluator", None)),
    ({"cluster": {"worker": ["a:1", "a:2"]},
      "task": {"type": "worker", "index": 1}}, ("train", None)),
    ("{not json", ("train", None)),
])
def test_job_auto_routes_before_any_process_group(tf_config, job,
                                                  monkeypatch):
    """--job auto reads TF_CONFIG as train.py does; the PS tier and the
    evaluator are entered before bootstrap could start a process group
    (which would count the ps tasks into its world and wait for them)."""
    monkeypatch.setenv("TF_CONFIG", tf_config if isinstance(tf_config, str)
                       else __import__("json").dumps(tf_config))
    args = train_torch.parse_args(["--test-size", "--device", "cpu"])
    assert train_torch.resolve_job(args) == job
    calls = []
    for name, role in (("run_ps_cluster_task", "ps-cluster"),
                       ("run_evaluator", "evaluator"),
                       ("run_async_ps", "async-ps"),
                       ("_train", "train")):
        monkeypatch.setattr(train_torch, name,
                            lambda *a, role=role: calls.append((role, a[1:])))

    def no_group(*a, **kw):
        raise AssertionError("a process group was started")

    monkeypatch.setattr(bootstrap, "initialize", no_group)
    train_torch.main(["--test-size", "--device", "cpu"])
    assert calls == [(job[0], job[1] or ())]
    assert not torch.distributed.is_initialized()
    train_torch.main(["--job", "async-ps", "--test-size", "--device", "cpu"])
    assert calls[-1] == ("async-ps", ())


def test_ps_cluster_tasks_run_to_their_push_budget():
    """1 ps + chief + worker of one TF_CONFIG cluster, each task
    ``run_ps_cluster_task`` on a thread of this process: the ps task
    absorbs exactly workers x steps pushes and both workers train."""
    cluster = {kind: [f"127.0.0.1:{bootstrap.free_port()}"]
               for kind in ("ps", "chief", "worker")}
    args = train_torch.parse_args(
        ["--workload", "widedeep", "--test-size", "--device", "cpu",
         "--steps", "3", "--batch-size", "16", "--idle-timeout", "30"])
    out, errors = {}, []

    def task(kind):
        try:
            out[kind] = train_torch.run_ps_cluster_task(args, cluster,
                                                        kind, 0)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append((kind, e))

    threads = [threading.Thread(target=task, args=(k,))
               for k in ("ps", "chief", "worker")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert out["ps"] == [{"ps_task": 0, "version": 6, "budget": 6}]
    assert out["chief"][0]["worker"] == 0 and out["worker"][0]["worker"] == 1
    for kind in ("chief", "worker"):
        rec, = out[kind]
        assert len(rec["losses"]) == 3
        assert sum(rec["staleness_hist"].values()) == 3
