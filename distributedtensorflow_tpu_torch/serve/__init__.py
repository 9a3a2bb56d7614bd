"""Serving engine of the port: paged KV cache, the prefill and decode
programs, host sampling and the continuous-batching ``Engine``.  Twin of
``distributedtensorflow_tpu/serve`` at its defaults (no prefix cache,
fused sampling, speculation or HTTP front yet)."""

from .engine import Engine, GenRequest, QueueFullError  # noqa: F401
from .kv_cache import BlockAllocator, OutOfBlocksError, PagedKVCache  # noqa: F401
