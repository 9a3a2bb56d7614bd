"""The tied LM head and its chunked cross-entropy loss.

Twin of ``distributedtensorflow_tpu/ops/xent.py``: ``chunked_argmax``
(``:44-80``) for teacher-forced eval, ``tied_head_logits`` (``:82-99``)
for serving and ``chunked_softmax_xent`` (``:102-181``) for training.
The fused head, the kernels K4f/K4b, lives in ``ops/fused_xent.py``.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

#: Tokens per chunk: at most one (C, V) fp32 logits tile is alive.
DEFAULT_CHUNK_TOKENS = 4096


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


def chunked_argmax(hidden: torch.Tensor, wte: torch.Tensor, *,
                   chunk_tokens: int = DEFAULT_CHUNK_TOKENS,
                   compute_dtype=None) -> torch.Tensor:
    """Greedy ids (B, S) int32 of ``hidden`` (B, S, D) under the tied
    table ``wte`` (V, D), without the full (B, S, V) logits: chunks of
    ``chunk_tokens`` rows, each one (C, V) fp32 tile of
    :func:`tied_head_logits`'s recipe, reduced to its argmax (ties to the
    first index, as ``jnp.argmax``).  The last chunk is the short tail,
    which JAX pads to the chunk for ``lax.scan``'s fixed shapes."""
    b, s, d = hidden.shape
    n = b * s
    dt = compute_dtype or torch.promote_types(hidden.dtype, wte.dtype)
    x = hidden.reshape(n, d).to(dt).float()
    wte_f = wte.to(dt).float()
    c = min(chunk_tokens, n)
    ids = [(x[lo:lo + c] @ wte_f.T).argmax(-1) for lo in range(0, n, c)]
    return torch.cat(ids).to(torch.int32).reshape(b, s)


def vocab_parallel_argmax(hidden: torch.Tensor, wte: torch.Tensor, shard, *,
                          compute_dtype=None) -> torch.Tensor:
    """:func:`chunked_argmax` with the table split by rows over a
    ``model`` group (``shard``, a ``models.layers.VocabShard``): each
    rank's best row and its logit, gathered; the largest logit wins, the
    lowest id among ties (the ranks hold the rows in order)."""
    from ..parallel.collectives import all_gather

    b, s, d = hidden.shape
    dt = compute_dtype or torch.promote_types(hidden.dtype, wte.dtype)
    logits = hidden.reshape(-1, d).to(dt).float() @ wte.to(dt).float().T
    val = logits.amax(-1)
    idx = logits.argmax(-1) + shard.offset  # the first of ties
    vals = all_gather(val[None], shard.group)
    ids = all_gather(idx[None], shard.group)
    best = vals.argmax(0)
    return ids.gather(0, best[None])[0].to(torch.int32).reshape(b, s)


def _chunk_nll(x_c, t_c, w_c, wte_f, logits_dtype):
    """Weighted NLL sum of one chunk: (C, V) logits stored in
    ``logits_dtype``, their fp32 logsumexp and the target logit."""
    logits = (x_c @ wte_f.T).to(logits_dtype)
    lse = torch.logsumexp(logits.float(), dim=-1)
    tgt = logits.gather(1, t_c[:, None])[:, 0].float()
    return ((lse - tgt) * w_c).sum()


def chunked_softmax_xent(hidden: torch.Tensor, wte: torch.Tensor,
                         targets: torch.Tensor, mask=None, *,
                         chunk_tokens: int = DEFAULT_CHUNK_TOKENS,
                         compute_dtype=None,
                         logits_dtype=None) -> torch.Tensor:
    """Mean masked next-token NLL of ``hidden`` (B, S, D) against the tied
    table ``wte`` (V, D) without the full (B, S, V) logits.

    Targets outside ``[0, V)`` weigh 0; the result is ``nll_sum /
    max(w_sum, 1)``.  Each chunk of ``chunk_tokens`` tokens runs under
    ``torch.utils.checkpoint``, so its logits are recomputed in the
    backward instead of kept (``jax.checkpoint(body)`` in JAX).  The
    operands are rounded to ``compute_dtype`` and multiplied with an fp32
    result, the recipe of :func:`tied_head_logits`.  ``logits_dtype=
    torch.bfloat16`` stores each tile in bf16 (``"chunked_bf16"``); the
    reductions stay fp32."""
    b, s, d = hidden.shape
    n = b * s
    v = wte.shape[0]
    x = hidden.reshape(n, d)
    t_raw = targets.reshape(n)
    t = t_raw.clamp(0, v - 1)
    w = (torch.ones(n, dtype=torch.float32, device=hidden.device)
         if mask is None else mask.reshape(n).to(torch.float32))
    w = w * ((t_raw >= 0) & (t_raw < v)).to(torch.float32)
    dt = compute_dtype or torch.promote_types(hidden.dtype, wte.dtype)
    wte_f = wte.to(dt).float()
    x = x.to(dt).float()
    c = min(chunk_tokens, n)
    nll_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    w_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, n, c):
        w_c = w[lo:lo + c]
        nll_sum = nll_sum + checkpoint(_chunk_nll, x[lo:lo + c], t[lo:lo + c],
                                       w_c, wte_f,
                                       logits_dtype or torch.float32,
                                       use_reentrant=False)
        w_sum = w_sum + w_c.sum()
    return nll_sum / torch.clamp(w_sum, min=1.0)
