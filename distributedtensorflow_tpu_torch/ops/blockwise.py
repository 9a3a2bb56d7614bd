"""Blockwise (chunked) token-wise computation for long sequences.

Twin of ``distributedtensorflow_tpu/ops/blockwise.py`` (``:23-54``): a
token-wise function applied over sequence chunks, each chunk under
``torch.utils.checkpoint`` (``jax.checkpoint`` in JAX), so the backward
keeps one (B, chunk, d_ff) intermediate alive instead of the whole
sequence's.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint


def blockwise_map(fn: Callable[[torch.Tensor], torch.Tensor],
                  x: torch.Tensor, chunk_size: int) -> torch.Tensor:
    """Apply token-wise ``fn`` over ``chunk_size`` slices of dim 1.

    ``fn`` must be elementwise over the sequence (true for MLPs, not for
    attention).  With grad enabled each chunk's intermediates are
    recomputed in the backward.  The sequence length must divide evenly."""
    length = x.shape[1]
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    if length % chunk_size:
        raise ValueError(f"sequence length {length} not divisible by "
                         f"chunk_size {chunk_size}")
    if chunk_size == length:
        return fn(x)
    remat = torch.is_grad_enabled()
    parts = [checkpoint(fn, part, use_reentrant=False) if remat else fn(part)
             for part in x.split(chunk_size, dim=1)]
    return torch.cat(parts, dim=1)
