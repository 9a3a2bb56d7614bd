"""Input of the port: the per-host split, the synthetic sources, the
resume fast-forward, bundles and the prefetcher
(``data/input_pipeline.py``); record files with auto-sharding
(``data/recordio_dataset.py``) and their tensor wire (``data/wire.py``)."""

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
from .recordio_dataset import (  # noqa: F401
    decode_example,
    encode_example,
    record_dataset,
    repeated_record_dataset,
    write_example,
    write_record_shards,
)
