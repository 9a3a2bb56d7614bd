"""Input of the port: the per-host split, the synthetic sources, the
resume fast-forward, bundles and the prefetcher
(``data/input_pipeline.py``)."""

from .input_pipeline import (  # noqa: F401
    InputContext,
    Prefetcher,
    current_input_context,
    device_put_batch,
    device_put_bundle,
    pack_sequences,
    skip_batches,
    synthetic_classification,
)
