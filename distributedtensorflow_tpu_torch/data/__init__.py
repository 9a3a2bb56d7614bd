"""Input of the port: the per-host split, the synthetic sources, the
resume fast-forward, bundles and the prefetcher
(``data/input_pipeline.py``) with its adaptive depth
(``data/adaptive.py``); record files with auto-sharding
(``data/recordio_dataset.py``) and their tensor wire (``data/wire.py``);
the disaggregated data service (``data/service.py``)."""

from .recordio_dataset import (  # noqa: F401
    decode_example,
    encode_example,
    record_dataset,
    repeated_record_dataset,
    write_example,
    write_record_shards,
)
from .service import (  # noqa: F401
    DataServiceClient,
    DispatcherJournal,
    DispatchServer,
    WorkerServer,
)
from .wire import (  # noqa: F401
    WireError,
    decode_tensors,
    encode_tensors,
)
from .input_pipeline import (  # noqa: F401
    AdaptiveDepthController,
    InputContext,
    Prefetcher,
    ReplicaBatches,
    broadcast_to_replica,
    current_input_context,
    device_put_batch,
    device_put_bundle,
    input_record_fields,
    make_input_fn_dataset,
    pack_sequences,
    replica_is_split,
    replica_leader,
    shard_dataset,
    skip_batches,
    synthetic_classification,
    tfdata_iterator,
)
