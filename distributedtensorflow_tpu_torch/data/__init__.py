"""Input of the port: the per-host split, the synthetic sources and the
resume fast-forward (``data/input_pipeline.py``)."""

from .input_pipeline import (  # noqa: F401
    InputContext,
    current_input_context,
    device_put_batch,
    pack_sequences,
    skip_batches,
    synthetic_classification,
)
