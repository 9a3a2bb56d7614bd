"""Metric writing and throughput counters of the port.

Twin of ``distributedtensorflow_tpu/utils/metrics.py`` (``:30-171``) with
its jsonl sink only, the sink the JAX writer keeps when TensorFlow is
absent: ``metrics.jsonl`` in the log directory, one strict-JSON object
per ``write`` (``{"step": ..., **scalars}``), non-finite floats as the
sentinel strings ``tools/check_metrics_schema.py`` reads.  The port runs
one process, which is the chief.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Mapping

import torch


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


class MetricWriter:
    """Appends scalar rows to ``<logdir>/metrics.jsonl`` (nothing without
    a logdir).  A context manager; ``close`` is idempotent and writes
    after it are dropped."""

    def __init__(self, logdir: str | None = None):
        self._jsonl = None
        self._closed = False
        if logdir is not None:
            os.makedirs(logdir, exist_ok=True)
            self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def write(self, step: int, scalars: Mapping[str, Any]) -> None:
        """One row: strings pass through, everything else as a float."""
        if self._closed or self._jsonl is None:
            return
        scalars = {k: (v if isinstance(v, str) else float(v))
                   for k, v in scalars.items() if v is not None}
        self._jsonl.write(json.dumps(json_sanitize({"step": step, **scalars}),
                                     allow_nan=False) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None

    def __enter__(self) -> "MetricWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ThroughputMeter:
    """steps/s, examples/s and examples/s per CUDA device (one on a
    machine without) since ``start``."""

    def __init__(self, global_batch_size: int):
        self.global_batch_size = global_batch_size
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
        n_dev = max(1, torch.cuda.device_count())
        return {"steps_per_sec": steps_per_sec,
                "examples_per_sec": ex_per_sec,
                "examples_per_sec_per_chip": ex_per_sec / n_dev}
