"""Serving engine of the port: the paged KV cache with its refcounted
allocator and prefix index (``kv_cache``), the serving programs (chunked
prefill, cache gather, paged decode, the fused decode/verify fast path;
``model``), the samplers (``sampling``), the n-gram drafter
(``draft``), the continuous-batching ``Engine`` with budgeted prefill,
metrics and log streams (``engine``) and the ``/generatez`` HTTP front
(``server``).  Twin of ``distributedtensorflow_tpu/serve``; entry
point: ``serve_torch.py`` at the repository root."""

from .engine import Engine, GenRequest, QueueFullError  # noqa: F401
from .kv_cache import BlockAllocator, OutOfBlocksError, PagedKVCache  # noqa: F401
from .model import (  # noqa: F401
    make_decode_fn,
    make_fused_decode_fn,
    make_gather_cache_fn,
    make_prefill_fn,
)
from .server import ServeServer  # noqa: F401
