"""Input splitting and synthetic sources of the port.

Twin of ``distributedtensorflow_tpu/data/input_pipeline.py``:
``InputContext`` (``:54-69``), the per-host split that the synthetic
sources read, and :func:`current_input_context` (``:72``), which fills it
from the rank's mesh (the ambient one of a ``Strategy.scope()`` when no
mesh is passed); :func:`shard_dataset`, :func:`tfdata_iterator` and
:func:`make_input_fn_dataset` (``:80``, ``:346``, ``:352``), which take
any dataset with ``.shard(n, i)`` and ``.as_numpy_iterator()`` (a
``tf.data.Dataset`` among them; the port does not import TensorFlow);
:func:`device_put_batch` (``:87``), which puts a host batch
on the device; ``synthetic_classification`` (``:321-342``) and
``pack_sequences`` (``:361-425``), copies with the same seeds and the same
numpy draws, so both packages see identical batches;
:func:`skip_batches` (``:429-454``), a resumed run's fast-forward; and
:func:`device_put_bundle` (``:104-124``) and :class:`Prefetcher`
(``:127-320``), which stack k batches for a multi-step call and put the
batches on the device from a thread of their own, at a fixed depth or
one that ``data/adaptive.py``'s controller tunes.  The port runs one
input pipeline per process, and one process per device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import logging
import queue
import threading
import time
import weakref
from typing import Any, Callable, Iterable, Iterator, Sequence

import numpy as np
import torch

from .. import obs
from ..parallel import collectives
from ..parallel.mesh import current_mesh, replica_count, replica_index
from .adaptive import (  # noqa: F401  (input_record_fields re-exported)
    AdaptiveDepthController,
    input_record_fields,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class InputContext:
    """Per-host input split info (``tf.distribute.InputContext``)."""

    num_input_pipelines: int = 1
    input_pipeline_id: int = 0
    global_batch_size: int = 0

    @property
    def per_host_batch_size(self) -> int:
        if self.global_batch_size % self.num_input_pipelines:
            raise ValueError(
                f"global batch {self.global_batch_size} not divisible by "
                f"{self.num_input_pipelines} hosts")
        return self.global_batch_size // self.num_input_pipelines


def current_input_context(global_batch_size: int,
                          mesh=None) -> InputContext:
    """One input pipeline per replica of ``mesh`` (default: the ambient
    mesh, ``parallel.mesh.current_mesh``; none: one in all), this rank's
    the ``input_pipeline_id``-th."""
    if mesh is None:
        mesh = current_mesh()
    return InputContext(
        num_input_pipelines=1 if mesh is None else replica_count(mesh),
        input_pipeline_id=0 if mesh is None else replica_index(mesh),
        global_batch_size=global_batch_size)


def shard_dataset(ds, ctx: InputContext):
    """The DATA-policy shard of ``ds`` for this input pipeline
    (``ds.shard(n, i)``; ``ds`` itself for one pipeline)."""
    if ctx.num_input_pipelines > 1:
        ds = ds.shard(ctx.num_input_pipelines, ctx.input_pipeline_id)
    return ds


def tfdata_iterator(ds) -> Iterator[Any]:
    """The batches of ``ds`` as numpy trees (``ds.as_numpy_iterator()``)."""
    yield from ds.as_numpy_iterator()


def make_input_fn_dataset(input_fn: Callable[[InputContext], Any],
                          global_batch_size: int, mesh=None):
    """``distribute_datasets_from_function`` (``input_lib.py:1077``):
    ``(input_fn(ctx), ctx)`` for this rank's :func:`current_input_context`."""
    ctx = current_input_context(global_batch_size, mesh)
    return input_fn(ctx), ctx


def _leaf_to_device(v, device) -> torch.Tensor:
    v = np.asarray(v)
    dtype = torch.long if v.dtype.kind in "iu" else None
    cuda = torch.device(device).type == "cuda"
    if v.flags.writeable:
        if not cuda:
            return torch.as_tensor(v, device=device, dtype=dtype)
        return torch.as_tensor(v, dtype=dtype).pin_memory().to(
            device, non_blocking=True)
    # a wire or record view (np.frombuffer): copied, never aliased (a
    # tensor over read-only memory is undefined to write); on the card
    # staged by numpy straight into pinned memory
    if not cuda:
        return torch.tensor(v, dtype=dtype, device=device)
    staged = torch.empty(v.shape, pin_memory=True, dtype=dtype or
                         torch.from_numpy(np.empty(0, v.dtype)).dtype)
    staged.numpy()[...] = v
    return staged.to(device, non_blocking=True)


def device_put_batch(batch: dict, device, mesh=None, *,
                     accum_steps: int = 1) -> dict:
    """A host batch (numpy leaves) on ``device``: integer leaves (ids,
    labels, segments) as ``torch.long``, float leaves in their own dtype.
    On a CUDA device each leaf is staged in pinned host memory and copied
    without blocking the host: a copy from pageable memory waits for the
    device to finish the work queued before it, which would make every
    step's batch a sync (the Trainer's host runs ahead of the card).

    ``batch`` is this rank's pipeline's rows.  JAX lays the global batch
    out rank-major (``make_array_from_process_local_data``) and splits it
    into ``accum_steps`` microbatches of consecutive global rows, so with
    ``accum_steps`` > 1 and more than one replica the rows this rank must
    train on (the ``r``-th 1/N of each microbatch: global rows ``i B/accum
    + r B/(accum N) + j``) lie in every rank's pipeline.  The ranks then
    gather the global batch and each keeps its rows, in microbatch order,
    so that :func:`..train.engine.split_microbatches` cuts it into its
    share of each JAX microbatch (:func:`exchange_rows`)."""
    out = {k: _leaf_to_device(v, device) for k, v in batch.items()}
    return exchange_rows(out, mesh, accum_steps)


#: The axes the ranks of one replica differ on, each with its group, in
#: the order :func:`broadcast_to_replica` crosses them.
_SPLIT_AXES = (("pipe", "pipe_group"), ("seq", "seq_group"),
               ("expert", "expert_group"), ("model", "model_group"))


def replica_leader(mesh=None) -> bool:
    """Whether this rank is its replica's first (coordinate 0 on every
    split axis): the one rank of the replica that reads a streaming input
    whose order is its own, as the data service's client."""
    return mesh is None or not any(mesh.coords[a] for a, _ in _SPLIT_AXES)


def broadcast_to_replica(batch: dict, mesh=None) -> dict:
    """The replica leader's ``batch`` on every rank of its replica.  A
    chain of broadcasts from group rank 0 (coordinate 0), one split axis
    at a time: over each axis the ranks at coordinate 0 on the axes after
    it pass it on, so after the last every rank holds the leader's.  Run
    on every rank of the mesh, on the consumer's thread (the collectives'
    order is the step's)."""
    if mesh is None:
        return batch
    for i, (axis, name) in enumerate(_SPLIT_AXES):
        if mesh.shape[axis] == 1 or any(
                mesh.coords[a] for a, _ in _SPLIT_AXES[i + 1:]):
            continue
        group = getattr(mesh, name)
        batch = {k: collectives.broadcast(v, group) for k, v in batch.items()}
    return batch


def replica_is_split(mesh=None) -> bool:
    """Whether a replica spans more than one rank (an axis of
    :data:`_SPLIT_AXES` larger than 1)."""
    return mesh is not None and any(mesh.shape[a] > 1
                                    for a, _ in _SPLIT_AXES)


def _leaves_spec(batch: dict | None, mesh, device) -> dict:
    """The replica leader's leaves, key -> (shape, dtype), on every rank
    of its replica: a JSON header broadcast as bytes, its length first."""
    header = None
    if batch is not None:
        header = torch.tensor(list(json.dumps(
            {k: [list(v.shape), str(v.dtype).removeprefix("torch.")]
             for k, v in batch.items()}).encode()),
            dtype=torch.uint8, device=device)
    n = torch.tensor([0 if header is None else header.numel()],
                     dtype=torch.long, device=device)
    n = int(broadcast_to_replica({"n": n}, mesh)["n"])
    if header is None:
        header = torch.empty(n, dtype=torch.uint8, device=device)
    header = broadcast_to_replica({"h": header}, mesh)["h"]
    return {k: (tuple(shape), getattr(torch, dtype)) for k, (shape, dtype)
            in json.loads(bytes(header.cpu().tolist())).items()}


class ReplicaBatches:
    """The replica leader's device batches on every rank of a replica
    split over ``pipe``, ``seq``, ``expert`` or ``model``: the leader
    (:func:`replica_leader`) reads ``batches`` and passes each on
    (:func:`broadcast_to_replica`, on the consumer's thread, before the
    step reads it); the others read no input (``batches`` None) and
    receive into empty ``device`` buffers of the leader's leaves, whose
    keys, shapes and dtypes come once, with the first batch.  Every later
    batch must have the first one's leaves (a streaming source's are
    one shape)."""

    def __init__(self, batches, mesh, device):
        self._batches, self._mesh = batches, mesh
        self._device = torch.device(device)
        self._spec = None

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        batch = None if self._batches is None else next(self._batches)
        if self._spec is None:
            self._spec = _leaves_spec(batch, self._mesh, self._device)
        if batch is None:
            batch = {k: torch.empty(shape, dtype=dtype, device=self._device)
                     for k, (shape, dtype) in self._spec.items()}
        elif {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} \
                != self._spec:
            raise ValueError("a replica's batches changed their leaves "
                             "after the first")
        return broadcast_to_replica(batch, self._mesh)

    def close(self) -> None:
        close = getattr(self._batches, "close", None)
        if close is not None:
            close()


def _needs_exchange(mesh, accum_steps: int) -> bool:
    return accum_steps > 1 and mesh is not None and replica_count(mesh) > 1


def exchange_rows(batch: dict, mesh=None, accum_steps: int = 1, *,
                  lead: int = 0) -> dict:
    """This rank's rows of every microbatch of the global batch (see
    :func:`device_put_batch`) from the ranks' pipelines' rows, one gather
    a leaf; the batch itself for one replica or one microbatch.  ``lead``
    leading dims (a bundle's step dim) are carried through."""
    if not _needs_exchange(mesh, accum_steps):
        return batch
    n, r = replica_count(mesh), replica_index(mesh)
    local = {}
    for k, x in batch.items():
        head, rest = x.shape[:lead], x.shape[lead + 1:]
        # the global batch, rank-major, viewed (..., accum, N, per, ...):
        # row (i, r, j) is row j of rank r's share of microbatch i
        full = collectives.all_gather(x.contiguous(), mesh.batch_group,
                                      gather_axis=lead)
        per = full.shape[lead] // (accum_steps * n)
        view = full.reshape(*head, accum_steps, n, per, *rest)
        local[k] = view[(slice(None),) * (lead + 1) + (r,)].reshape(
            *head, accum_steps * per, *rest)
    return local


def device_put_bundle(batches: Sequence[dict], device, mesh=None, *,
                      accum_steps: int = 1) -> dict:
    """Stack ``k`` host batches into one (k, B, ...) tensor per leaf on
    ``device``, the input of ``train.engine.make_multi_train_step``.  The
    stack happens on the host (numpy) before the copy, one copy a leaf;
    with ``accum_steps`` > 1 over replicas each step's rows are then
    exchanged as :func:`device_put_batch` exchanges them."""
    stacked = {k: np.stack([np.asarray(b[k]) for b in batches])
               for k in batches[0]}
    out = {k: _leaf_to_device(v, device) for k, v in stacked.items()}
    return exchange_rows(out, mesh, accum_steps, lead=1)


def _host_bundles(it: Iterator, bundle: int) -> Iterator:
    """``it`` itself, or lists of ``bundle`` consecutive batches; a
    trailing short group at its true length."""
    if bundle <= 1:
        yield from it
        return
    while True:
        group = list(itertools.islice(it, bundle))
        if group:
            yield group
        if len(group) < bundle:
            return


class Prefetcher:
    """Host-to-device prefetch on a thread of its own (twin of the
    reference's ``Prefetcher``, ``:127-320``): the thread reads the
    source, puts each batch on ``device`` and keeps ``buffer_size`` of
    them ready; the training loop pops them.  ``bundle`` > 1 stacks that
    many consecutive host batches into one (bundle, B, ...) tensor a leaf
    (:func:`device_put_bundle`), the input of ``steps_per_call``
    training; a trailing short group is yielded at its true length.

    On a CUDA device the thread copies on a CUDA stream of its own, from
    pinned staging buffers, without blocking; each batch carries an event
    that the consumer's stream waits on before the step reads it, and
    ``record_stream`` keeps the allocator from handing the batch's memory
    to another tensor while a step queued on the consumer's stream still
    reads it.  With ``accum_steps`` > 1 over replicas the ranks' row
    exchange (collectives on the training group) runs on the consumer's
    thread, in step order with the step's own collectives, never from
    the worker.

    An exception in the source or the copy is raised on the consumer's
    thread.  ``note_consumed(n)`` of a source that has it is called as
    batches reach the consumer (n: the batches of the bundle).  The
    registry gets ``data_batches_total``, ``data_wait_seconds`` and
    ``data_device_put_seconds``.  :meth:`close` stops the thread and
    releases the buffered batches and the source; a Prefetcher that is
    dropped without it stops its thread too.

    ``adaptive=True`` hands the depth to an
    :class:`~.adaptive.AdaptiveDepthController` seeded at ``buffer_size``
    (or pass your own ``controller``): the thread admits a batch only
    while fewer than the live depth wait, so the queue deepens while the
    consumer blocks on data and shallows when its waits are about 0,
    within ``[1, max_depth]`` and ``bytes_budget`` host bytes (each host
    batch's bytes are noted before its copy).  The live depth is
    :attr:`depth`, the gauge ``data_prefetch_depth{component=
    "prefetcher"}`` and the record field ``data_prefetch_depth``.
    """

    _DONE = object()

    def __init__(self, it: Iterable, device, mesh=None, buffer_size: int = 2,
                 *, bundle: int = 1, accum_steps: int = 1,
                 adaptive: bool = False, max_depth: int = 16,
                 bytes_budget: int | None = None,
                 controller: AdaptiveDepthController | None = None):
        if controller is None and adaptive:
            controller = AdaptiveDepthController(
                initial=buffer_size, min_depth=1, max_depth=max_depth,
                bytes_budget=bytes_budget, component="prefetcher")
        self._controller = controller
        self._device = torch.device(device)
        if self._device.type == "cuda" and self._device.index is None:
            # the worker thread must name the consumer's card
            self._device = torch.device("cuda", torch.cuda.current_device())
        self._mesh, self._accum = mesh, accum_steps
        self._bundle = bundle
        self._depth = max(1, int(buffer_size))
        self._q: queue.Queue = queue.Queue()
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._err: list = []
        self._m_batches = obs.counter(
            "data_batches_total", "batches handed to the consumer")
        self._m_wait = obs.histogram(
            "data_wait_seconds", "consumer blocking time per batch fetch")
        self._src = it
        self._note_consumed = getattr(it, "note_consumed", None)
        # the worker holds no reference to self, so a dropped Prefetcher
        # is collected and its finalizer stops the thread
        self._thread = threading.Thread(
            target=_prefetch_worker, daemon=True, name="prefetcher",
            args=(iter(it), self._device, bundle, self._depth, controller,
                  self._q, self._cond, self._stop, self._err,
                  obs.histogram("data_device_put_seconds",
                                "host->device placement time per batch")))
        self._finalizer = weakref.finalize(self, _stop_worker, self._stop,
                                           self._cond)
        self._thread.start()

    def close(self) -> None:
        """Stop the worker, drop the buffered device batches and close the
        source (a generator gets its ``GeneratorExit``)."""
        _stop_worker(self._stop, self._cond)
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5)
        if self._controller is not None:
            self._controller.unregister()
        close = getattr(self._src, "close", None)
        if callable(close) and not self._thread.is_alive():
            try:
                close()
            except Exception:  # source cleanup only
                logger.warning("input source close() failed", exc_info=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        item = self._q.get()
        wait = time.perf_counter() - t0
        self._m_wait.observe(wait)
        with self._cond:
            self._cond.notify_all()  # a slot is free
        if item is self._DONE:
            if self._err:
                raise self._err[0]
            raise StopIteration
        if self._controller is not None:
            self._controller.observe_wait(wait)
        out, count, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            for x in out.values():
                x.record_stream(stream)
        self._m_batches.inc()
        if self._note_consumed is not None:
            self._note_consumed(count)
        return exchange_rows(out, self._mesh, self._accum,
                             lead=1 if self._bundle > 1 else 0)

    @property
    def depth(self) -> int:
        """The live prefetch depth (fixed unless adaptive)."""
        return self._controller.depth if self._controller is not None \
            else self._depth


def _host_bytes(batch) -> int:
    """Host bytes of a numpy batch, or of a list of them (a bundle)."""
    if isinstance(batch, dict):
        return sum(int(getattr(v, "nbytes", 0)) for v in batch.values())
    return sum(_host_bytes(b) for b in batch)


def _stop_worker(stop: threading.Event, cond: threading.Condition) -> None:
    stop.set()
    with cond:
        cond.notify_all()


def _prefetch_worker(it, device, bundle, depth, controller, q, cond, stop,
                     err, m_put):
    """The Prefetcher's thread: batches (or bundles) onto ``device`` and
    into ``q`` while fewer than ``depth`` (the ``controller``'s live depth
    where there is one) wait there; then the end mark."""

    def admit(item) -> bool:
        with cond:
            while not stop.is_set() and q.qsize() >= (
                    depth if controller is None else controller.depth):
                cond.wait(0.1)
            if stop.is_set():
                return False
            q.put(item)
            return True

    cuda = device.type == "cuda"
    stream = None
    try:
        if cuda:
            torch.cuda.set_device(device)
            stream = torch.cuda.Stream(device)
        for batch in _host_bundles(it, bundle):
            if stop.is_set():
                return
            if controller is not None:
                # the budget's unit: the host bytes before the copy
                controller.note_bytes(_host_bytes(batch))
            t0 = time.perf_counter()
            with torch.cuda.stream(stream) if cuda \
                    else contextlib.nullcontext():
                out = (device_put_bundle(batch, device) if bundle > 1
                       else device_put_batch(batch, device))
                event = None
                if cuda:
                    event = torch.cuda.Event()
                    event.record(stream)
            m_put.observe(time.perf_counter() - t0)
            if not admit((out, len(batch) if bundle > 1 else 1, event)):
                return
    except BaseException as e:  # raised on the consumer's thread
        err.append(e)
    finally:
        admit(Prefetcher._DONE)


def synthetic_classification(
    ctx: InputContext,
    *,
    image_shape: tuple[int, ...],
    num_classes: int,
    seed: int = 0,
    dtype=np.float32,
    steps: int | None = None,
) -> Iterator[dict[str, np.ndarray]]:
    """Endless synthetic labelled NHWC images (the host's share of the
    global batch).  Class-conditional means keep the task learnable, so
    a loss can fall."""
    rng = np.random.default_rng(seed + ctx.input_pipeline_id)
    n = ctx.per_host_batch_size
    i = 0
    while steps is None or i < steps:
        labels = rng.integers(0, num_classes, size=(n,))
        images = rng.standard_normal((n, *image_shape), dtype=np.float32) * 0.1
        images += (labels / num_classes).reshape((n,) + (1,) * len(image_shape))
        yield {"image": images.astype(dtype), "label": labels.astype(np.int32)}
        i += 1


def pack_sequences(examples, seq_len: int, *, pad_value: int = 0,
                   extra_keys: Sequence[str] = (),
                   fill_values: dict | None = None):
    """Greedy next-fit packing of variable-length token examples: each
    row takes whole examples in arrival order until the next one does not
    fit.  Yields dicts of (seq_len,) int32 arrays: ``input_ids``,
    ``segment_ids`` (1-based per packed example, 0 = padding),
    ``position_ids`` (restarting at 0 per example) and each of
    ``extra_keys``, packed alongside; a key's padding is
    ``fill_values[key]``, else -100 for keys ending in ``"labels"`` (the
    ignore index) and ``pad_value`` for the rest.  An example longer than
    ``seq_len`` is truncated."""
    fills = {
        key: (fill_values or {}).get(
            key, -100 if key.endswith("labels") else pad_value)
        for key in extra_keys
    }

    def new_row():
        row = {
            "input_ids": np.full(seq_len, pad_value, np.int32),
            "segment_ids": np.zeros(seq_len, np.int32),
            "position_ids": np.zeros(seq_len, np.int32),
        }
        for key in extra_keys:
            row[key] = np.full(seq_len, fills[key], np.int32)
        return row, 0, 0  # row, used, n_segments

    row, used, n_seg = new_row()
    for ex in examples:
        ids = np.asarray(ex["input_ids"], np.int32)[:seq_len]
        n = len(ids)
        if n == 0:
            continue
        if used + n > seq_len:
            yield row
            row, used, n_seg = new_row()
        sl = slice(used, used + n)
        row["input_ids"][sl] = ids
        row["segment_ids"][sl] = n_seg + 1
        row["position_ids"][sl] = np.arange(n)
        for key in extra_keys:
            row[key][sl] = np.asarray(ex[key], np.int32)[:n]
        used += n
        n_seg += 1
    if used:
        yield row


def skip_batches(it: Iterator, n: int) -> Iterator:
    """Fast-forward an input iterator past ``n`` already-consumed batches
    and return it.

    The inputs are deterministic functions of ``(seed, step)``, so a run
    restored to step N drains N batches of its host stream, before they
    are put on the device, and goes on with the batches the uninterrupted
    run would have drawn; otherwise it would train on the first N batches
    again and diverge.  A stream that ends first is logged, and the
    iterator returned as it is.  The drain is the ``input_fastforward``
    span, which the goodput ledger books as restore time."""
    with obs.span("input_fastforward"):
        for i in range(n):
            try:
                next(it)
            except StopIteration:
                logger.warning("input exhausted after skipping %d/%d "
                               "batches on resume", i, n)
                break
    return it
