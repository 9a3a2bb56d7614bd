"""Input splitting of the port.

Twin of ``InputContext`` in ``distributedtensorflow_tpu/data/
input_pipeline.py`` (``:54-69``): the per-host split that the synthetic
sources read.  The port runs one input pipeline per process.
"""

from __future__ import annotations

import dataclasses


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
