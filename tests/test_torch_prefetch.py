"""The port's input prefetcher and bundles (``data/input_pipeline.py``):
twins of the JAX package's ``Prefetcher`` tests
(``tests/test_input_pipeline.py`` and ``tests/test_elastic.py``'s
acknowledgement tests) on the CPU, ``device_put_bundle`` against the
JAX ``device_put_bundle`` on the same host batches, the row exchange of a
bundle over two thread ranks, the registry's input metrics, the refusal
of the adaptive depth, and the TensorBoard sink of ``MetricWriter``.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from distributedtensorflow_tpu.data.input_pipeline import (
    device_put_bundle as jax_device_put_bundle,
)
from distributedtensorflow_tpu.parallel import MeshSpec as JaxMeshSpec
from distributedtensorflow_tpu.parallel import build_mesh as jax_build_mesh
from distributedtensorflow_tpu_torch import obs
from distributedtensorflow_tpu_torch.data import (
    InputContext,
    Prefetcher,
    device_put_batch,
    device_put_bundle,
    synthetic_classification,
)
from distributedtensorflow_tpu_torch.parallel.mesh import MeshSpec, build_mesh
from distributedtensorflow_tpu_torch.testing import run_ranks
from distributedtensorflow_tpu_torch.utils.metrics import MetricWriter


def _source(steps=None, seed=0):
    return synthetic_classification(InputContext(1, 0, 8),
                                    image_shape=(4, 4, 1), num_classes=2,
                                    seed=seed, steps=steps)


class _AckSource:
    """A finite source that records its consumption acknowledgements."""

    def __init__(self, n):
        self._it = iter([{"x": np.full((8, 2), i, np.float32)}
                         for i in range(n)])
        self.acks = []

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._it)

    def note_consumed(self, n=1):
        self.acks.append(n)


def test_prefetcher_yields_all_and_stops():
    out = list(Prefetcher(_source(steps=5), "cpu", buffer_size=2))
    assert len(out) == 5
    assert out[0]["image"].shape == (8, 4, 4, 1)
    assert out[0]["label"].dtype == torch.long
    want = [device_put_batch(b, "cpu") for b in _source(steps=5)]
    for got, ref in zip(out, want):
        for k in ref:
            assert torch.equal(got[k], ref[k])


def test_prefetcher_propagates_errors():
    def bad_source():
        yield {"image": np.zeros((8, 2), np.float32)}
        raise RuntimeError("input broke")

    it = iter(Prefetcher(bad_source(), "cpu"))
    next(it)
    with pytest.raises(RuntimeError, match="input broke"):
        next(it)
        next(it)


def test_prefetcher_close_releases_thread():
    """Finite consumption of an endless source must not leak the worker;
    close() also closes the source (a generator gets GeneratorExit)."""
    src = _source()
    pf = Prefetcher(src, "cpu", buffer_size=2)
    next(iter(pf))
    pf.close()
    assert not pf._thread.is_alive()
    assert pf._q.empty()
    with pytest.raises(StopIteration):
        next(src)


def test_dropped_prefetcher_stops_its_thread():
    """A Prefetcher dropped without close() stops its thread: the worker
    holds no reference to it, and its finalizer sets the stop."""
    pf = Prefetcher(_source(), "cpu", buffer_size=2)
    next(pf)
    thread = pf._thread
    del pf
    import gc

    gc.collect()
    thread.join(timeout=5)
    assert not thread.is_alive()


def test_prefetcher_finite_source_terminates_with_slow_consumer():
    """A finite source that ends while the buffer is full still delivers
    its end: the consumer drains the batches and stops."""
    def batches():
        for i in range(6):
            yield {"x": np.full((8, 2), i, np.float32)}

    pf = Prefetcher(batches(), "cpu", buffer_size=2)
    time.sleep(0.3)
    got = list(pf)
    assert [int(b["x"][0, 0]) for b in got] == list(range(6))


def test_prefetcher_acks_on_output_side():
    src = _AckSource(4)
    pf = Prefetcher(src, "cpu", buffer_size=4)
    time.sleep(0.3)  # the worker buffers eagerly: buffering must not ack
    assert src.acks == []
    assert sum(1 for _ in pf) == 4
    assert src.acks == [1] * 4


def test_prefetcher_acks_true_bundle_length():
    """Five batches at bundle 2: two bundles of 2 and a trailing one of
    1, each acknowledged at its length, each stacked (n, 8, 2)."""
    src = _AckSource(5)
    pops = list(Prefetcher(src, "cpu", buffer_size=4, bundle=2))
    assert [p["x"].shape[0] for p in pops] == [2, 2, 1]
    assert src.acks == [2, 2, 1]
    assert [int(v) for v in pops[2]["x"][:, 0, 0]] == [4]


def test_prefetcher_counts_into_the_registry():
    reg = obs.Registry()
    prev = obs.registry.set_default_registry(reg)
    try:
        list(Prefetcher(_source(steps=3), "cpu"))
    finally:
        obs.registry.set_default_registry(prev)
    scalars = reg.scalars()
    assert scalars["data_batches_total"] == 3
    assert scalars["data_wait_seconds_count"] == 4  # and the end
    assert scalars["data_device_put_seconds_count"] == 3


def test_adaptive_prefetch_is_not_ported():
    """The adaptive depth is ported now (``data/adaptive.py``; the name
    stays): ``adaptive=True`` seeds a controller at ``buffer_size`` within
    ``max_depth`` and the budget, a given controller is the one used, and
    either yields the batches a fixed depth yields."""
    from distributedtensorflow_tpu_torch.data import AdaptiveDepthController

    want = [b["image"] for b in Prefetcher(_source(steps=5), "cpu")]
    with Prefetcher(_source(steps=5), "cpu", buffer_size=3, adaptive=True,
                    max_depth=4, bytes_budget=1 << 20) as pf:
        ctl = pf._controller
        assert (ctl.depth, ctl.max_depth, ctl.bytes_budget,
                ctl.component) == (3, 4, 1 << 20, "prefetcher")
        got = [b["image"] for b in pf]
    mine = AdaptiveDepthController(initial=1, component="prefetcher")
    with Prefetcher(_source(steps=5), "cpu", controller=mine) as pf:
        assert pf._controller is mine and pf.depth == 1
        got2 = [b["image"] for b in pf]
    for a, b, c in zip(want, got, got2, strict=True):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_device_put_bundle_matches_jax(devices):
    """Three host batches stacked into (3, 8, ...) leaves with the values
    of the JAX ``device_put_bundle`` on a one-device mesh; integer leaves
    as ``torch.long``."""
    batches = list(_source(steps=3, seed=4))
    got = device_put_bundle(batches, "cpu")
    ref = jax_device_put_bundle(
        batches, jax_build_mesh(JaxMeshSpec(data=1), devices[:1]))
    assert got.keys() == ref.keys()
    for k in got:
        assert tuple(got[k].shape) == ref[k].shape == (3, 8) + \
            batches[0][k].shape[1:]
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    assert got["label"].dtype == torch.long
    assert got["image"].dtype == torch.float32


@pytest.mark.parametrize("through", ["bundle", "prefetcher"])
def test_bundle_rows_exchange_over_thread_ranks(through):
    """Two thread ranks, two microbatches: each step of a bundle holds
    this rank's rows of each microbatch of the global batch, the rows
    ``device_put_batch`` gives that step alone (the exchange runs on the
    consumer's thread, so the Prefetcher's worker issues no collective)."""
    world, accum, k = 2, 2, 3
    hosts = [[{"x": np.arange(8 * r * 100 + 8 * i, 8 * r * 100 + 8 * i + 8,
                              dtype=np.float32).reshape(8, 1)}
              for i in range(k)] for r in range(world)]

    def body(rank, group):
        mesh = build_mesh(MeshSpec(data=world), group)
        if through == "bundle":
            out = device_put_bundle(hosts[rank], "cpu", mesh,
                                    accum_steps=accum)
        else:
            pf = Prefetcher(iter(hosts[rank]), "cpu", mesh, bundle=k,
                            accum_steps=accum)
            out = next(pf)
            pf.close()
        single = [device_put_batch(b, "cpu", mesh, accum_steps=accum)
                  for b in hosts[rank]]
        return out, single, threading.current_thread().name

    for out, single, _ in run_ranks(body, world):
        assert out["x"].shape == (k, 8, 1)
        for i in range(k):
            assert torch.equal(out["x"][i], single[i]["x"])


def test_metric_writer_tensorboard_sink(tmp_path):
    """The sink writes every numeric scalar to TensorBoard event files
    beside metrics.jsonl (strings to the jsonl row only)."""
    pytest.importorskip("tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    with MetricWriter(str(tmp_path), chief=True) as w:
        assert w.tensorboard
        w.write(1, {"loss": 2.5, "mode": "x"})
        w.write(2, {"loss": 1.5})
    acc = EventAccumulator(str(tmp_path))
    acc.Reload()
    assert acc.Tags()["scalars"] == ["loss"]
    assert [(e.step, e.value) for e in acc.Scalars("loss")] == [(1, 2.5),
                                                              (2, 1.5)]
    assert (tmp_path / "metrics.jsonl").read_text().count("\n") == 2


def test_metric_writer_without_tensorboard(tmp_path, monkeypatch):
    """When the import fails the writer keeps metrics.jsonl alone, as the
    JAX writer does without TensorFlow; ``use_tensorboard=False`` asks for
    that."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with MetricWriter(str(tmp_path / "a"), chief=True) as w:
        assert not w.tensorboard
        w.write(1, {"loss": 2.5})
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == \
        ["metrics.jsonl"]
    monkeypatch.undo()
    with MetricWriter(str(tmp_path / "b"), use_tensorboard=False,
                      chief=True) as w:
        assert not w.tensorboard
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == \
        ["metrics.jsonl"]
