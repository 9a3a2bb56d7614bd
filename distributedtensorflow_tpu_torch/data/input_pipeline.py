"""Input splitting and synthetic sources of the port.

Twin of ``distributedtensorflow_tpu/data/input_pipeline.py``:
``InputContext`` (``:54-69``), the per-host split that the synthetic
sources read, and :func:`current_input_context` (``:72``), which fills it
from the rank; :func:`device_put_batch` (``:87``), which puts a host batch
on the device; ``synthetic_classification`` (``:321-342``) and
``pack_sequences`` (``:361-425``), copies with the same seeds and the same
numpy draws, so both packages see identical batches; and
:func:`skip_batches` (``:429-454``), a resumed run's fast-forward.  The port runs one
input pipeline per process, and one process per device.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Iterator, Sequence

import numpy as np
import torch

from ..parallel import collectives
from ..parallel.mesh import replica_count, replica_index

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
    """One input pipeline per replica of ``mesh`` (none: one in all),
    this rank's the ``input_pipeline_id``-th."""
    return InputContext(
        num_input_pipelines=1 if mesh is None else replica_count(mesh),
        input_pipeline_id=0 if mesh is None else replica_index(mesh),
        global_batch_size=global_batch_size)


def device_put_batch(batch: dict, device, mesh=None, *,
                     accum_steps: int = 1) -> dict:
    """A host batch (numpy leaves) on ``device``: integer leaves (ids,
    labels, segments) as ``torch.long``, float leaves in their own dtype.

    ``batch`` is this rank's pipeline's rows.  JAX lays the global batch
    out rank-major (``make_array_from_process_local_data``) and splits it
    into ``accum_steps`` microbatches of consecutive global rows, so with
    ``accum_steps`` > 1 and more than one replica the rows this rank must
    train on (the ``r``-th 1/N of each microbatch: global rows ``i B/accum
    + r B/(accum N) + j``) lie in every rank's pipeline.  The ranks then
    gather the global batch and each keeps its rows, in microbatch order,
    so that :func:`..train.engine.split_microbatches` cuts it into its
    share of each JAX microbatch."""
    out = {k: torch.as_tensor(v, device=device,
                              dtype=torch.long if v.dtype.kind in "iu"
                              else None)
           for k, v in batch.items()}
    n = 1 if mesh is None else replica_count(mesh)
    if accum_steps == 1 or n == 1:
        return out
    r = replica_index(mesh)
    local = {}
    for k, x in out.items():
        full = collectives.all_gather(x, mesh)  # (N b, ...), rank-major
        per = full.shape[0] // (accum_steps * n)
        local[k] = full.view(accum_steps, n, per, *x.shape[1:])[:, r] \
            .reshape(accum_steps * per, *x.shape[1:])
    return local


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
    iterator returned as it is."""
    for i in range(n):
        try:
            next(it)
        except StopIteration:
            logger.warning("input exhausted after skipping %d/%d batches "
                           "on resume", i, n)
            break
    return it
