"""Input splitting and synthetic sources of the port.

Twin of ``distributedtensorflow_tpu/data/input_pipeline.py``:
``InputContext`` (``:54-69``), the per-host split that the synthetic
sources read; ``synthetic_classification`` (``:321-342``) and
``pack_sequences`` (``:361-425``), copies with the same seeds and the same
numpy draws, so both packages see identical batches.  The port runs one
input pipeline per process.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np


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
