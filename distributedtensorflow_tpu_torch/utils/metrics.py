"""Metric writing and throughput counters of the port.

Twin of ``distributedtensorflow_tpu/utils/metrics.py`` (``:30-171``):
``metrics.jsonl`` in the log directory, one strict-JSON object per
``write`` (``{"step": ..., **scalars}``), non-finite floats as the
sentinel strings ``tools/check_metrics_schema.py`` reads, and beside it
TensorBoard event files of the numeric scalars through
``torch.utils.tensorboard.SummaryWriter`` (JAX's writer takes
``tf.summary``); when that import fails the writer keeps the jsonl sink
alone, as the JAX writer does without TensorFlow (``:58-65``).  Of the
ranks of a data-parallel run only the chief (process 0) writes, as
``train.py``'s trainer does.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Mapping

from ..parallel import bootstrap


def json_sanitize(value: Any) -> Any:
    """Non-finite floats as "NaN"/"Infinity"/"-Infinity", recursively."""
    if isinstance(value, float) and not math.isfinite(value):
        if math.isnan(value):
            return "NaN"
        return "Infinity" if value > 0 else "-Infinity"
    if isinstance(value, dict):
        return {k: json_sanitize(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [json_sanitize(v) for v in value]
    return value


def _tensorboard_writer(logdir: str):
    """A ``SummaryWriter`` on ``logdir``, or None when TensorBoard is
    missing or broken (the jsonl sink then stands alone)."""
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter(log_dir=logdir)
    except Exception:
        return None


class MetricWriter:
    """Appends scalar rows to ``<logdir>/metrics.jsonl`` and, with
    ``use_tensorboard`` and TensorBoard importable, their numeric fields
    to TensorBoard event files in ``logdir`` (nothing without a logdir,
    and nothing on a process other than the chief: ``chief`` None asks
    :func:`..parallel.bootstrap.is_chief`).  A context manager; ``close``
    is idempotent and writes after it are dropped."""

    def __init__(self, logdir: str | None = None, *,
                 use_tensorboard: bool = True, chief: bool | None = None):
        self._jsonl = None
        self._tb = None
        self._closed = False
        if chief is None:
            chief = bootstrap.is_chief()
        if logdir is not None and chief:
            os.makedirs(logdir, exist_ok=True)
            if use_tensorboard:
                self._tb = _tensorboard_writer(logdir)
            self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")

    @property
    def tensorboard(self) -> bool:
        """Whether the TensorBoard sink is on."""
        return self._tb is not None

    def write(self, step: int, scalars: Mapping[str, Any]) -> None:
        """One row: strings pass through (to the jsonl row only),
        everything else as a float."""
        if self._closed or self._jsonl is None:
            return
        scalars = {k: (v if isinstance(v, str) else float(v))
                   for k, v in scalars.items() if v is not None}
        if self._tb is not None:
            for k, v in scalars.items():
                if not isinstance(v, str):
                    self._tb.add_scalar(k, v, step)
            self._tb.flush()
        self._jsonl.write(json.dumps(json_sanitize({"step": step, **scalars}),
                                     allow_nan=False) + "\n")
        self._jsonl.flush()

    def write_record(self, record: Mapping[str, Any]) -> None:
        """Append one free-form JSON record (chief only, flushed): for
        rows that are not step-keyed scalars (the async parameter
        server's progress records carry a nested staleness histogram)."""
        if self._closed or self._jsonl is None:
            return
        self._jsonl.write(json.dumps(json_sanitize(dict(record)),
                                     allow_nan=False) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._tb is not None:
            self._tb.close()
            self._tb = None
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None

    def __enter__(self) -> "MetricWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ThroughputMeter:
    """steps/s, examples/s of the global batch, and examples/s per chip
    (over ``n_chips``, by default the processes of the run, each driving
    one device) since ``start``."""

    def __init__(self, global_batch_size: int, n_chips: int | None = None):
        self.global_batch_size = global_batch_size
        self.n_chips = n_chips or bootstrap.process_count()
        self._t0: float | None = None
        self._steps = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0

    def update(self, n_steps: int = 1) -> None:
        if self._t0 is None:
            self.start()
        self._steps += n_steps

    def rates(self) -> dict[str, float]:
        if not self._t0 or not self._steps:
            return {}
        steps_per_sec = self._steps / (time.perf_counter() - self._t0)
        ex_per_sec = steps_per_sec * self.global_batch_size
        return {"steps_per_sec": steps_per_sec,
                "examples_per_sec": ex_per_sec,
                "examples_per_sec_per_chip": ex_per_sec / self.n_chips}
