"""The tied LM head of the serving path.

Twin of ``tied_head_logits`` in ``distributedtensorflow_tpu/ops/xent.py``
(``:82-99``).  The loss heads (``chunked_softmax_xent``, the fused
kernel K4) belong to the training slice.
"""

from __future__ import annotations

import torch


def tied_head_logits(x: torch.Tensor, wte: torch.Tensor,
                     compute_dtype=None) -> torch.Tensor:
    """fp32 logits ``x @ wte.T`` with both operands rounded to
    ``compute_dtype`` and the products summed in fp32.

    JAX takes bf16 operands with an fp32 result that is never rounded to
    bf16; a torch bf16 matmul would round it and can flip greedy ties.
    So the rounded operands are widened back to fp32 (exact) and
    multiplied in fp32.  That costs an fp32 GEMM and an fp32 copy of the
    table per call, which a later performance change can remove."""
    dt = compute_dtype or torch.promote_types(x.dtype, wte.dtype)
    return x.to(dt).float() @ wte.to(dt).float().T
