"""The port's input plane against the JAX package's: the adaptive depth
controller (``data/adaptive.py``), the Prefetcher's adaptive depth
(``data/input_pipeline.py``), the batch wire of the data service
(``data/service.py``'s ``encode_batch``/``decode_batch`` over
``data/wire.py``) and ``train_torch.py``'s five input-plane flags.

The same ``note_bytes``/``observe_wait`` sequences give the two
controllers the same depth after every call and the same resize counts;
a starved consumer grows the port's prefetch depth, a throttled one
shrinks it, and the bytes budget caps it (the JAX package's own tests of
its Prefetcher, ``tests/test_input_plane.py:196-257``, on the CPU
device); the raw wire's bytes are equal in both packages and each
package decodes the other's npz; a decoded batch (read-only views of the
frame) goes to the device without a warning and unwritten; and
``train_torch.main`` at test size through ``--data-service 2
--adaptive-prefetch`` writes the depths into every record, in a logdir
that ``tools/check_metrics_schema.py`` and ``tools/run_report.py`` pass.
"""

import json
import os
import time
import warnings

import numpy as np
import pytest
import torch

from distributedtensorflow_tpu.data import adaptive as jadaptive
from distributedtensorflow_tpu.data import service as jservice
from distributedtensorflow_tpu.obs import registry as jregistry
from distributedtensorflow_tpu_torch.data import (
    AdaptiveDepthController,
    Prefetcher,
    device_put_batch,
    input_record_fields,
)
from distributedtensorflow_tpu_torch.data import adaptive as tadaptive
from distributedtensorflow_tpu_torch.data import service as tservice
from distributedtensorflow_tpu_torch.obs import registry as tregistry
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401
import train_torch


@pytest.fixture(autouse=True)
def _no_live_controllers():
    """Each test starts and ends without a registered controller (the
    registry of live controllers is process-wide, last made wins)."""
    for mod in (tadaptive, jadaptive):
        with mod._CONTROLLERS_LOCK:
            mod._CONTROLLERS.clear()
    yield
    for mod in (tadaptive, jadaptive):
        with mod._CONTROLLERS_LOCK:
            mod._CONTROLLERS.clear()


# ------------------------------------------------------------- controller


def _ops(seed, n=400):
    """A seeded mix of batch sizes and consumer waits: long, short and
    middling waits in runs, so the depth climbs, falls and holds."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        if rng.random() < 0.2:
            ops.append(("bytes", int(rng.integers(1, 64)) * 4096))
        else:
            scale = rng.choice([5e-2, 1e-5, 1e-3])
            ops.append(("wait", float(scale * rng.random() * 2)))
    return ops


@pytest.mark.parametrize("seed,budget,initial,interval", [
    (0, None, 2, 8), (1, 1 << 20, 4, 4), (2, 512 * 1024, 1, 3),
    (3, 4 << 20, 16, 1)])
def test_controller_trajectory_and_resizes_match_jax(seed, budget, initial,
                                                     interval):
    # the schema tool's two components: the registry is process-wide, and
    # a later metrics.prom of this process carries these labels too
    component = ("prefetcher", "client")[seed % 2]
    kw = dict(initial=initial, min_depth=1, max_depth=16, interval=interval,
              bytes_budget=budget, component=component)
    jc = jadaptive.AdaptiveDepthController(**kw)
    tc = AdaptiveDepthController(**kw)
    jres = jregistry.counter("data_prefetch_resizes_total")
    tres = tregistry.counter("data_prefetch_resizes_total")
    labels = [dict(direction=d, component=component)
              for d in ("grow", "shrink")]
    j0 = [jres.value(**lab) for lab in labels]
    t0 = [tres.value(**lab) for lab in labels]
    jpath, tpath = [jc.depth], [tc.depth]
    for kind, x in _ops(seed):
        if kind == "bytes":
            jc.note_bytes(x)
            tc.note_bytes(x)
        else:
            assert tc.observe_wait(x) == jc.observe_wait(x)
        jpath.append(jc.depth)
        tpath.append(tc.depth)
        assert tc.byte_cap() == jc.byte_cap()
        assert tc.item_bytes == jc.item_bytes
    assert tpath == jpath
    assert len(set(tpath)) > 2  # the sequence moved the depth both ways
    jd = [jres.value(**lab) - j for lab, j in zip(labels, j0)]
    td = [tres.value(**lab) - t for lab, t in zip(labels, t0)]
    assert td == jd and sum(td) > 0
    gauge = tregistry.gauge("data_prefetch_depth")
    assert gauge.value(component=component) == tc.depth


@pytest.mark.parametrize("kw", [
    dict(min_depth=0), dict(min_depth=4, max_depth=2),
    dict(grow_wait_s=1e-4, shrink_wait_s=1e-3)])
def test_controller_refuses_what_jax_refuses(kw):
    with pytest.raises(ValueError) as jerr:
        jadaptive.AdaptiveDepthController(**kw)
    with pytest.raises(ValueError) as terr:
        AdaptiveDepthController(**kw)
    assert str(terr.value) == str(jerr.value)


def test_input_record_fields_match_jax():
    assert input_record_fields() == jadaptive.input_record_fields() == {}
    for mod in (jadaptive, tadaptive):
        mod.AdaptiveDepthController(initial=3, component="prefetcher")
        c = mod.AdaptiveDepthController(initial=5, max_depth=8,
                                        component="client")
        for _ in range(4):
            c.observe_wait(0.5)
    assert input_record_fields() == jadaptive.input_record_fields() == {
        "data_prefetch_depth": 3.0, "data_client_window": 5.0}
    for _ in range(8):
        tadaptive._CONTROLLERS["client"].observe_wait(0.5)
    assert input_record_fields()["data_client_window"] == 6.0


# ------------------------------------------------------------- prefetcher


def test_prefetcher_starved_consumer_grows_depth():
    def slow_source():
        for i in range(30):
            time.sleep(0.02)  # producer-bound: the consumer blocks
            yield {"x": np.full((2, 2), i, np.float32)}

    ctl = AdaptiveDepthController(initial=2, max_depth=8, interval=4)
    with Prefetcher(slow_source(), "cpu", buffer_size=2,
                    controller=ctl) as pf:
        got = [int(b["x"][0, 0]) for b in pf]
        assert pf.depth == ctl.depth
        assert input_record_fields()["data_prefetch_depth"] == ctl.depth
    assert got == list(range(30))
    assert ctl.depth > 2, "a starved consumer must grow the depth"
    assert input_record_fields() == {}  # the closed Prefetcher's left


def test_prefetcher_throttled_consumer_shrinks_depth():
    ctl = AdaptiveDepthController(initial=6, max_depth=8, interval=4)
    n = 0
    with Prefetcher(({"x": np.full((2, 2), i, np.float32)}
                     for i in range(30)), "cpu", buffer_size=6,
                    controller=ctl) as pf:
        for _ in pf:
            time.sleep(0.02)  # consumer-bound: the waits are about 0
            n += 1
    assert n == 30
    assert ctl.depth < 6, "a throttled consumer must shrink the depth"


@pytest.mark.parametrize("bundle", [1, 2])
def test_prefetcher_depth_within_bytes_budget(bundle):
    """The budget caps the depth at ``budget // item bytes``, the item
    a bundle of ``bundle`` host batches; ``adaptive=True`` makes the
    controller itself."""
    item = np.zeros((64, 64), np.float32)  # 16 KiB

    def source():
        for _ in range(40):
            time.sleep(0.005)
            yield {"x": item}

    budget = 4 * item.nbytes * bundle
    with Prefetcher(source(), "cpu", buffer_size=2, bundle=bundle,
                    adaptive=True, max_depth=32,
                    bytes_budget=budget) as pf:
        depths = []
        for _ in pf:
            depths.append(pf.depth)
        ctl = pf._controller
    assert ctl.component == "prefetcher" and ctl.max_depth == 32
    assert ctl.item_bytes == item.nbytes * bundle
    assert max(depths) <= 4, depths


def test_prefetcher_fixed_depth_without_controller():
    pf = Prefetcher(({"x": np.full((2,), i, np.float32)} for i in range(6)),
                    "cpu", buffer_size=3)
    assert pf.depth == 3 and pf._controller is None
    assert [int(b["x"][0]) for b in pf] == list(range(6))
    assert input_record_fields() == {}


def test_read_only_wire_batch_placed_without_warning_or_write():
    """A raw-wire batch decodes to read-only ``np.frombuffer`` views;
    placing it copies them, silently, and leaves them as they were."""
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, 512, (4, 8), dtype=np.int32),
             "x": rng.standard_normal((4, 3), dtype=np.float32)}
    wire = tservice.encode_batch(batch, wire="raw")
    got = tservice.decode_batch(wire)
    assert not any(v.flags.writeable for v in got.values())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        placed = device_put_batch(got, "cpu")
        placed["x"].add_(1.0)  # the device copy is the step's to write
    assert placed["input_ids"].dtype == torch.long
    np.testing.assert_array_equal(placed["input_ids"].numpy(),
                                  batch["input_ids"])
    np.testing.assert_array_equal(got["x"], batch["x"])
    assert tservice.encode_batch(got, wire="raw") == wire


# ------------------------------------------------------------------- wire


def _wire_batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((2, 4, 4, 3), dtype=np.float32),
            "label": rng.integers(0, 10, (2,)).astype(np.int32),
            "mask": rng.random((2, 5)) > 0.5,
            "ids": rng.integers(-9, 9, (3, 2)).astype(np.int64),
            "half": rng.standard_normal((3,)).astype(np.float16),
            "scalar": np.float64(2.5),
            "strided": np.arange(12, dtype=np.int16).reshape(3, 4)[:, ::2]}


@pytest.mark.parametrize("crc", [False, True])
def test_raw_wire_bytes_equal_jax(crc):
    batch = _wire_batch()
    trace = {"trace_id": "t" * 16, "span_id": "s" * 8}
    for kw in (dict(), dict(trace=trace)):
        tbytes = tservice.encode_batch(batch, wire="raw", crc=crc, **kw)
        assert tbytes == jservice.encode_batch(batch, wire="raw", crc=crc,
                                               **kw)
    for dec in (tservice.decode_batch, jservice.decode_batch):
        out = dec(tbytes)
        assert list(out) == list(batch)
        for k, v in batch.items():
            assert out[k].dtype == np.asarray(v).dtype
            np.testing.assert_array_equal(out[k], v)


def test_npz_wire_decodes_across_packages():
    batch = _wire_batch(1)
    for enc, dec in ((tservice.encode_batch, jservice.decode_batch),
                     (jservice.encode_batch, tservice.decode_batch)):
        out = dec(enc(batch, wire="npz"))
        assert sorted(out) == sorted(batch)
        for k, v in batch.items():
            np.testing.assert_array_equal(out[k], v)
    with pytest.raises(ValueError, match="unknown wire format"):
        tservice.encode_batch(batch, wire="pickle")


# ------------------------------------------------------------ train_torch

TINY = ["--workload", "gpt_lm", "--test-size", "--device", "cpu",
        "--log-every", "1", "--seed", "0"]


def test_input_plane_flags_take_train_py_defaults_and_refusals():
    args = train_torch.parse_args([])
    assert (args.data_service, args.data_service_wire,
            args.data_service_window, args.adaptive_prefetch,
            args.prefetch_budget_mb) == (0, "raw", 0, False, 256.0)
    for bad in (["--adaptive-prefetch", "--prefetch-depth", "0"],
                ["--data-service", "-1"]):
        with pytest.raises(SystemExit):
            train_torch.main([*TINY, "--steps", "1", *bad])
    with pytest.raises(SystemExit):
        train_torch.parse_args(["--data-service-wire", "pickle"])


def test_main_through_the_service_writes_the_input_plane(tmp_path):
    """``--data-service 2 --adaptive-prefetch --logdir``: every record has
    both depths and one fetch histogram a worker; the journal, metrics,
    trace and Prometheus files pass the schema tool; the report's input
    plane names both workers; the workers and the dispatcher are gone
    when ``main`` returns."""
    from tools import check_metrics_schema, run_report

    from distributedtensorflow_tpu_torch import obs

    # the registry is the process's: an earlier run's workers stay in it
    before = set(obs.default_registry().scalars())
    logdir = str(tmp_path / "run")
    records = train_torch.main([*TINY, "--steps", "4", "--data-service",
                                "2", "--adaptive-prefetch", "--logdir",
                                logdir])
    assert [r["step"] for r in records] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) for r in records)
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    rows = [r for r in rows if "t_step" in r]
    assert len(rows) == 4
    for r in rows:
        assert r["data_prefetch_depth"] >= 1 and r["data_client_window"] >= 1
        fetch = [k for k in r if k not in before and k.startswith(
            "data_service_fetch_seconds_count.worker_")]
        assert len(fetch) == 2, fetch
    paths = [os.path.join(logdir, name) for name in (
        "metrics.jsonl", "metrics.prom", "dispatcher.journal")]
    assert check_metrics_schema.main(paths) == 0
    assert run_report.main([logdir]) == 0
    report = run_report.build_report(logdir)
    plane = report["input_plane"]
    assert len(plane["workers"]) >= 2
    assert plane["data_prefetch_depth"] >= 1
    with open(os.path.join(logdir, "dispatcher.journal")) as f:
        kinds = [json.loads(line)["kind"] for line in f]
    assert kinds[:4] == ["open", "worker_register", "worker_register",
                         "epoch_start"]
    assert kinds.count("worker_deregister") == 2  # stopped by main
