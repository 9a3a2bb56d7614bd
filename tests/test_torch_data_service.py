"""The port's data service (``data/service.py``) against the JAX
package's, in one process, over loopback sockets.

Each ``distributed_epoch`` below delivers every batch exactly once: the
port's client and servers alone (both wires, both protocols), a JAX
client reading from a port dispatcher and port workers and a port client
reading from JAX's (the wire and the protocol are the reference's byte
for byte), and a port worker killed mid-epoch, whose splits the
dispatcher hands to the survivors with their delivered counts (JAX's
``tests/test_data_service.py:134``).  A ``dispatcher.journal`` written
by either package's dispatcher replays in the other's, a torn tail
included; a port worker refuses a retired epoch and serves its status
page.  Then ``train_torch.py``'s ``--data-service``: one split trains on
exactly the worker's stream (losses equal, bit for bit, to the run fed
that stream directly), a resume in the same ``--logdir`` trains as the
uncut run (each run's dispatcher starts a new journal), over ``data=2``
each thread rank runs its own service on its own pipeline with its own
journal, over ``model=2`` or ``pipe=2`` only the replica's first rank
reads the service and every rank steps on its batches (broadcast over
the split axes; the others read no input), and ``--fleet`` scrapes every
worker as ``data_worker{i}``.  Heartbeats and timeouts are cut to
fractions of a second.
"""

import dataclasses
import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

from distributedtensorflow_tpu.data import service as jservice
from distributedtensorflow_tpu_torch.data import service as tservice
from distributedtensorflow_tpu_torch.obs import registry as tregistry
from distributedtensorflow_tpu_torch.parallel.mesh import MeshSpec
from distributedtensorflow_tpu_torch.testing import run_mesh
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401
from distributedtensorflow_tpu_torch.testing.threads import intra_op_threads
import train_torch

PACKAGES = {"jax": jservice, "port": tservice}
FAST = dict(heartbeat_interval_s=0.2)


def _sharded_input_fn(n_total=24, batch=2):
    """Batches of consecutive ids, each split its slice of them."""

    def input_fn(split, num_shards):
        ids = np.arange(n_total)[split::num_shards]
        for i in range(0, len(ids) - len(ids) % batch, batch):
            yield {"id": ids[i:i + batch].astype(np.int64),
                   "x": np.full((batch, 3), float(split), np.float32)}

    return input_fn


class _Service:
    """A dispatcher and ``n`` workers of ``servers``' package; stopped
    (workers first) on exit."""

    def __init__(self, servers, n, n_total=24, journal=None, **worker_kw):
        mod = PACKAGES[servers]
        self.dispatcher = mod.DispatchServer(port=0, worker_timeout_s=5.0,
                                             journal_path=journal)
        self.workers = [mod.WorkerServer(self.dispatcher.target(),
                                         _sharded_input_fn(n_total), port=0,
                                         **FAST, **worker_kw)
                        for _ in range(n)]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for w in self.workers:
            w.stop()
        self.dispatcher.stop()


def _ids(batches):
    return sorted(np.concatenate([b["id"] for b in batches]).tolist())


@pytest.mark.parametrize("wire", ["raw", "npz"])
@pytest.mark.parametrize("protocol", ["streaming", "per_connection"])
def test_distributed_epoch_exactly_once(wire, protocol):
    with _Service("port", 3) as svc:
        with tservice.DataServiceClient(svc.dispatcher.target(), wire=wire,
                                        protocol=protocol) as client:
            got = list(client)
        assert _ids(got) == list(range(24))
        assert {int(b["x"][0, 0]) for b in got} == {0, 1, 2}


@pytest.mark.parametrize("wire", ["raw", "npz"])
@pytest.mark.parametrize("client,servers", [("jax", "port"),
                                            ("port", "jax")])
def test_interop_exactly_once(client, servers, wire):
    """One package's client over the other's dispatcher and workers:
    the same batches, each once."""
    with _Service(servers, 3, n_total=60) as svc:
        with PACKAGES[client].DataServiceClient(
                svc.dispatcher.target(), wire=wire, window=3) as c:
            got = list(c)
            counts = c.received_counts()
        assert _ids(got) == list(range(60))
        assert sum(counts.values()) == len(got) == 30
        for b in got:
            assert b["id"].dtype == np.int64 and b["x"].dtype == np.float32


def test_elastic_reshard_loses_zero_records():
    """A port worker killed mid-epoch (no deregistration): its splits
    move to the survivors past the batches the client counted, and the
    epoch still delivers every record once."""
    dropped = tregistry.counter("data_service_workers_dropped_total")
    moved = tregistry.counter("data_service_resharded_splits_total")
    d0, m0 = dropped.value(), moved.value()
    with _Service("port", 3, n_total=240) as svc:
        client = tservice.DataServiceClient(svc.dispatcher.target(),
                                            window=2, stream_retries=1)
        try:
            got = [next(client) for _ in range(6)]  # every split under way
            svc.workers[0].kill()
            got += list(client)
            gen = client._gen
        finally:
            client.close()
        svc.workers = svc.workers[1:]
        assert _ids(got) == list(range(240)), \
            "the reshard lost or repeated records"
        assert gen >= 1
        assert dropped.value() == d0 + 1 and moved.value() >= m0 + 1


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_journal_replays_across_packages(writer, reader, tmp_path):
    """A dispatcher of ``writer`` journals registrations, an epoch, a
    reshard and a client's progress; ``reader``'s dispatcher made on the
    same file (a torn last line appended) has the same workers, the same
    epoch view and continues the seq chain."""
    path = str(tmp_path / "dispatcher.journal")
    w = PACKAGES[writer]
    d = w.DispatchServer(port=0, journal_path=path)
    call = w._rpc
    for addr in ("127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3"):
        call(d.target(), {"kind": "register_worker", "addr": addr})
    view, _ = call(d.target(), {"kind": "start_epoch", "epoch": "7"})
    call(d.target(), {"kind": "report_progress", "epoch": "7",
                      "client": "c", "received": {"0": 3, "1": 2}})
    call(d.target(), {"kind": "report_worker_failure", "epoch": "7",
                      "addr": "127.0.0.1:2", "split": 1,
                      "received": {"1": 2}})
    want, _ = call(d.target(), {"kind": "get_assignments", "epoch": "7"})
    workers, _ = call(d.target(), {"kind": "get_workers"})
    d.stop()
    assert want["gen"] == 1 and want["splits"]["1"]["skip"] == 2
    with open(path, "a") as f:
        f.write('{"seq": 99, "kind": "client_prog')  # a crash mid-append
    n_before = len(w.DispatcherJournal.replay(path)[0])
    r = PACKAGES[reader]
    d2 = r.DispatchServer(port=0, journal_path=path)
    try:
        got, _ = r._rpc(d2.target(), {"kind": "get_assignments",
                                      "epoch": "7"})
        got_workers, _ = r._rpc(d2.target(), {"kind": "get_workers"})
    finally:
        d2.stop()
    assert got == want
    assert got_workers == workers
    records, torn = r.DispatcherJournal.replay(path)
    assert not torn  # the reopening cut the torn tail
    assert [row["kind"] for row in records[n_before:]] == ["replay"]
    assert [row["seq"] for row in records] == list(range(len(records)))
    assert records[-1]["restored_epochs"] == 1
    assert records[-1]["restored_workers"] == 2


def test_worker_refuses_retired_epoch_and_serves_status():
    with _Service("port", 0) as svc:
        w = tservice.WorkerServer(svc.dispatcher.target(),
                                  _sharded_input_fn(), port=0,
                                  max_cached_epochs=1, status_port=0, **FAST)
        try:
            req = {"kind": "get_next", "epoch": "0", "gen": 0, "split": 0,
                   "num_shards": 1, "skip": 0, "wire": "raw"}
            header, data = w._handle(req)
            assert header["ok"] and not header["eof"]
            assert w._handle(dict(req, epoch="1"))[0]["ok"]
            header, _ = w._handle(req)  # epoch 0 left the 1-entry cache
            assert not header["ok"] and "retired" in header["error"]
            status = urllib.request.urlopen(
                f"http://{w.status_addr}/statusz", timeout=5).read().decode()
            assert "data_worker" in status and w.addr in status
            assert w._status()["data_worker"]["batches_served"] == 2
            health = urllib.request.urlopen(
                f"http://{w.status_addr}/healthz", timeout=5).read().decode()
            assert '"ok": true' in health
        finally:
            w.stop()


# ------------------------------------------------------------ train_torch

TINY = ["--workload", "gpt_lm", "--test-size", "--device", "cpu",
        "--log-every", "1", "--seed", "0", "--dtype", "float32"]


def _worker_stream(monkeypatch):
    """``train_torch.get_workload`` whose preset reads the stream of the
    service's split 0 (seed ``--seed + 1009``) directly."""
    real = train_torch.get_workload

    def get(*a, **kw):
        wl = real(*a, **kw)
        fn = wl.input_fn
        return dataclasses.replace(
            wl, input_fn=lambda ctx, seed: fn(ctx, seed + 1009))

    monkeypatch.setattr(train_torch, "get_workload", get)


def test_one_split_trains_on_the_workers_stream_bit_for_bit(monkeypatch):
    """``--data-service 1``: one split keeps the order, so the losses are
    the direct feed's of the same stream, bit for bit."""
    argv = [*TINY, "--steps", "4", "--adaptive-prefetch"]
    with intra_op_threads(1):
        served = train_torch.main([*argv, "--data-service", "1",
                                   "--data-service-window", "3"])
        _worker_stream(monkeypatch)
        direct = train_torch.main(argv)
    assert [r["loss"] for r in served] == [r["loss"] for r in direct]
    assert len({r["loss"] for r in served}) == 4


def _main_on_ranks(argv, spec, world):
    """``train_torch.main(argv)`` on thread ranks, each rank's mesh in
    place of the process group ``bootstrap_mesh`` would start."""
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


def test_data_axis_ranks_each_run_their_own_service(monkeypatch):
    """``--mesh data=2``: each rank serves and reads its own pipeline's
    split, so one split each equals the direct feed over the ranks."""
    argv = [*TINY, "--steps", "3", "--mesh", "data=2", "--dist-backend",
            "gloo"]
    with intra_op_threads(1):
        served = _main_on_ranks([*argv, "--data-service", "1"],
                                MeshSpec(data=2), 2)
        _worker_stream(monkeypatch)
        direct = _main_on_ranks(argv, MeshSpec(data=2), 2)
    assert [[r["loss"] for r in rank] for rank in served] == \
        [[r["loss"] for r in rank] for rank in direct]


def _epoch_starts(path):
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return [r for r in rows if r["kind"] == "epoch_start"]


def test_data_axis_ranks_keep_their_own_journals(monkeypatch, tmp_path):
    """``--mesh data=2`` with one ``--logdir``: each rank's dispatcher
    journals to its own file (pipeline 0's ``dispatcher.journal``,
    pipeline 1's ``dispatcher.1.journal``) and serves its own pipeline
    alone, so the losses still equal the direct feed over the ranks."""
    logdir = str(tmp_path / "run")
    argv = [*TINY, "--steps", "3", "--mesh", "data=2", "--dist-backend",
            "gloo"]
    with intra_op_threads(1):
        served = _main_on_ranks([*argv, "--data-service", "1", "--logdir",
                                 logdir], MeshSpec(data=2), 2)
        _worker_stream(monkeypatch)
        direct = _main_on_ranks(argv, MeshSpec(data=2), 2)
    assert [[r["loss"] for r in rank] for rank in served] == \
        [[r["loss"] for r in rank] for rank in direct]
    journals = [os.path.join(logdir, name) for name in
                ("dispatcher.journal", "dispatcher.1.journal")]
    starts = [_epoch_starts(j) for j in journals]
    assert [[(s["epoch"], s["num_shards"]) for s in st] for st in starts] \
        == [[("0", 1)], [("0", 1)]]
    assert starts[0][0]["splits"]["0"]["addr"] != \
        starts[1][0]["splits"]["0"]["addr"]


def test_resume_through_the_service_is_the_uncut_run(tmp_path):
    """A rerun in the same ``--logdir`` starts its dispatcher on a new
    journal: an earlier run's (two workers, now gone) is not replayed,
    so a ``--checkpoint-dir`` resume at ``--data-service 1`` reads its
    one worker's stream from batch 0, fast-forwards, and trains as the
    uncut run, bit for bit."""
    logdir, ckpt = str(tmp_path / "run"), str(tmp_path / "ckpt")
    argv = [*TINY, "--data-service", "1"]
    with intra_op_threads(1):
        uncut = train_torch.main([*argv, "--steps", "4", "--logdir",
                                  str(tmp_path / "uncut")])
        train_torch.main([*TINY, "--data-service", "2", "--steps", "1",
                          "--logdir", logdir])
        first = train_torch.main([*argv, "--steps", "2", "--logdir", logdir,
                                  "--checkpoint-dir", ckpt])
        resumed = train_torch.main([*argv, "--steps", "4", "--logdir",
                                    logdir, "--checkpoint-dir", ckpt])
    assert [r["step"] for r in first + resumed] == [1, 2, 3, 4]
    assert [r["loss"] for r in first + resumed] == \
        [r["loss"] for r in uncut]
    starts = _epoch_starts(os.path.join(logdir, "dispatcher.journal"))
    assert [(s["epoch"], s["num_shards"]) for s in starts] == [("0", 1)]


@pytest.mark.parametrize("spec,world", [
    (MeshSpec(data=1, pipe=2, model=2), 4), (MeshSpec(data=2, model=2), 4)])
def test_broadcast_to_replica_gives_every_rank_its_leaders_batch(spec, world):
    """The chain of broadcasts over the split axes: every rank of a
    replica ends with its leader's (coordinate 0 on every split axis)
    batch, each replica its own."""
    from distributedtensorflow_tpu_torch.data import (
        broadcast_to_replica,
        replica_leader,
    )

    def body(rank, mesh):
        batch = {"ids": torch.full((2, 3), rank, dtype=torch.long),
                 "x": torch.full((2,), float(rank))}
        got = broadcast_to_replica(batch, mesh)
        return replica_leader(mesh), int(got["ids"][0, 0]), \
            float(got["x"][1])

    out = run_mesh(body, spec, world)
    per_replica = world // spec.data
    for rank, (leader, ids, x) in enumerate(out):
        first = rank - rank % per_replica
        assert leader == (rank == first)
        assert ids == first and x == float(first)


@pytest.mark.parametrize("spec,world", [
    (MeshSpec(data=1, pipe=2, model=2), 4), (MeshSpec(data=2, seq=2), 4)])
def test_replica_batches_receive_the_leaders_leaves(spec, world):
    """Only a replica's leader reads batches; the other ranks build empty
    buffers from the leaves' keys, shapes and dtypes the leader sends
    once, and every rank steps on the leader's batches.  A later batch
    whose leaves differ from the first's is refused."""
    from distributedtensorflow_tpu_torch.data import (
        ReplicaBatches,
        replica_leader,
    )

    def body(rank, mesh):
        def mine():
            for i in range(3):
                yield {"ids": torch.full((2, 3), 10 * rank + i,
                                         dtype=torch.long),
                       "x": torch.full((2,), float(rank), dtype=torch.bfloat16)}
            yield {"ids": torch.zeros((1, 3), dtype=torch.long)}

        leader = replica_leader(mesh)
        batches = ReplicaBatches(mine() if leader else None, mesh, "cpu")
        got = [next(batches) for _ in range(3)]
        refused = False
        if leader:
            try:
                next(batches)
            except ValueError:
                refused = True
        return ([(int(b["ids"][1, 2]), float(b["x"][0]), b["x"].dtype)
                 for b in got], refused)

    out = run_mesh(body, spec, world)
    per_replica = world // spec.data
    for rank, (got, refused) in enumerate(out):
        first = rank - rank % per_replica
        assert got == [(10 * first + i, float(first), torch.bfloat16)
                       for i in range(3)]
        assert refused == (rank == first)


def _batches_on_ranks(monkeypatch):
    """``train_torch.build`` whose step records, per thread rank, the
    batches it built and then the ids of every batch it takes."""
    build, seen = train_torch.build, {}

    def recording_build(args, *rest, **kw):
        wl, state, step, batches = build(args, *rest, **kw)
        mine = seen.setdefault(threading.get_ident(), [])
        mine.append(batches)

        def recorded(state, batch):
            mine.append(batch["input_ids"].clone())
            return step(state, batch)

        return wl, state, recorded, batches

    monkeypatch.setattr(train_torch, "build", recording_build)
    return seen


@pytest.mark.parametrize("mesh", ["data=1,model=2", "data=1,pipe=2"])
def test_split_replica_trains_on_its_leaders_batches(monkeypatch, mesh):
    """Over a split axis only the replica's first rank reads the service;
    every rank takes its batches (two splits, whose arrival order is the
    leader client's own), so every rank steps on the same batches."""
    seen = _batches_on_ranks(monkeypatch)
    argv = [*TINY, "--steps", "3", "--mesh", mesh, "--dist-backend",
            "gloo", "--data-service", "2"]
    spec = MeshSpec(**{k: int(v) for k, v in
                       (part.split("=") for part in mesh.split(","))})
    records = _main_on_ranks(argv, spec, 2)
    assert len(seen) == 2
    (lead, *first), (other, *second) = seen.values()
    # the other rank reads no input of its own: it receives the leader's
    assert {lead._batches is None, other._batches is None} == {True, False}
    assert len(first) == len(second) == 3
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert [r["loss"] for r in records[0]] == [r["loss"] for r in records[1]]


def test_split_replica_with_one_split_is_the_direct_feed(monkeypatch):
    """``data=1,model=2`` at ``--data-service 1``: the leader's one split
    broadcast to the model ranks trains as the direct feed of the same
    stream on both ranks, bit for bit."""
    argv = [*TINY, "--steps", "3", "--mesh", "data=1,model=2",
            "--dist-backend", "gloo"]
    spec = MeshSpec(data=1, model=2)
    with intra_op_threads(1):
        served = _main_on_ranks([*argv, "--data-service", "1"], spec, 2)
        _worker_stream(monkeypatch)
        direct = _main_on_ranks(argv, spec, 2)
    assert [[r["loss"] for r in rank] for rank in served] == \
        [[r["loss"] for r in rank] for rank in direct]


def test_fleet_scrapes_the_data_workers(tmp_path):
    logdir = str(tmp_path / "run")
    train_torch.main([*TINY, "--steps", "3", "--data-service", "2",
                      "--status-port", "0", "--fleet", "--fleet-interval",
                      "0.2", "--logdir", logdir])
    with open(os.path.join(logdir, "fleet.json")) as f:
        peers = json.load(f)["peers"]
    assert {"chief", "data_worker0", "data_worker1"} <= set(peers)


def test_records_through_the_service(tmp_path):
    """``--data-dir`` through the service: worker ``split`` reads records
    pipeline ``id x N + split`` of ``pipelines x N`` with seed ``--seed +
    split``, so one worker reads what the direct ``--data-dir`` run reads
    (losses bit for bit) and two split the records between them."""
    from distributedtensorflow_tpu_torch.data import write_record_shards

    rng = np.random.default_rng(0)
    write_record_shards(
        iter([{"image": rng.standard_normal((28, 28, 1)).astype(np.float32),
               "label": np.int32(rng.integers(10))} for _ in range(48)]),
        str(tmp_path / "train-{:02d}.rec"), num_shards=1)
    argv = ["--workload", "mnist_lenet", "--test-size", "--device", "cpu",
            "--batch-size", "8", "--data-dir", str(tmp_path),
            "--shuffle-buffer", "16", "--log-every", "1", "--steps", "4"]
    with intra_op_threads(1):
        direct = train_torch.main(argv)
        served = train_torch.main([*argv, "--data-service", "1"])
        split = train_torch.main([*argv, "--data-service", "2",
                                  "--data-service-wire", "npz"])
    assert [r["loss"] for r in served] == [r["loss"] for r in direct]
    assert len(split) == 4 and all(np.isfinite(r["loss"]) for r in split)
