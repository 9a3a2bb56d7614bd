"""Fused linear + softmax cross-entropy: the LM head, kernels K4f and K4b.

Twin of ``distributedtensorflow_tpu/ops/fused_xent.py``.
:func:`fused_softmax_xent` has the JAX entry's signature and reduction
(``:572-609``): the mean masked next-token NLL of the tied head, where
the (N, V) logits never reach memory.  It runs through
:class:`FusedXentFn`, whose forward launches K4f (per-token logsumexp
and target logit) and whose backward launches K4b dx and K4b dw, the
twins of ``_fused_fwd``/``_fused_bwd`` (``:393-437``).

A CUDA tensor goes to the hand-written kernels ``csrc/fused_xent_fwd.cu``
(the port of ``_fwd_kernel``, ``:136``) and ``csrc/fused_xent_bwd.cu``
(``_bwd_dx_kernel``, ``:180``, and ``_bwd_dw_kernel``, ``:214``); a CPU
tensor to the plain twins :func:`xent_fwd_plain`, :func:`xent_dx_plain`
and :func:`xent_dw_plain`, which the kernels are checked against on the
card.  Semantics pinned from the JAX module:

- logits from operands rounded to ``compute_dtype``, fp32 products and
  sums (``:398-399``);
- a target outside [0, V) matches no row (tgt 0) and weighs 0
  (``:599-604``); the loss is ``sum((lse - tgt) * w_row) /
  max(sum(w_row), 1)`` (``:406-407``);
- the backward takes ``c = g * w_row / w_sum`` (``:423``), recomputes
  ``p = exp(logit - lse)`` and rounds ``dlog = c * (p - onehot)`` to the
  operand dtype before each product (``:204-207``, ``:230-233``); dx is
  cast to the hidden's dtype, dw to the table's (``:432-433``), and the
  mask gets a zero cotangent.

:func:`vocab_parallel_xent` is the head over a table split by rows
over a ``model`` group (tensor parallelism): K4f and K4b on this rank's
rows, the lse and the target logits combined over the ranks.

The TPU-only machinery is left out: the ``DTFT_XENT_*`` tile overrides,
the forward's VMEM token super-chunking (``_max_fwd_token_blocks``) and
the Mosaic tile choice by width are VMEM budgets, not semantics.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _cuda
from ._cuda import SMEM_LIMIT
from .xent import DEFAULT_CHUNK_TOKENS

#: Hidden sizes the backward kernels are built for (templates in
#: ``csrc/fused_xent_bwd.cu``); the forward takes any multiple of 64
#: (:func:`xent_fwd_plan`).
HIDDEN_SIZES = (128, 768, 1024)

_FWD_SIGNATURES = {"dtf_xent_fwd": [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 11 + [ctypes.c_void_p]}
_BWD_SIGNATURES = {
    name: [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    for name in ("dtf_xent_bwd_dx", "dtf_xent_bwd_dw")
}


def fused_softmax_xent(hidden: torch.Tensor, wte: torch.Tensor,
                       targets: torch.Tensor, mask=None, *,
                       compute_dtype=None) -> torch.Tensor:
    """Mean masked next-token NLL of ``hidden`` (B, S, D) or (N, D)
    against the tied table ``wte`` (V, D); ``targets`` and ``mask`` (1 =
    count) shaped like the tokens.  The same reduction and out-of-range
    target semantics as ``ops.xent.chunked_softmax_xent``."""
    v, d = wte.shape
    x2 = hidden.reshape(-1, d)
    n = x2.shape[0]
    t = targets.reshape(n).to(torch.int32)
    w_row = (torch.ones(n, dtype=torch.float32, device=hidden.device)
             if mask is None else mask.reshape(n).to(torch.float32))
    w_row = w_row * ((t >= 0) & (t < v)).to(torch.float32)
    op_dtype = compute_dtype or torch.promote_types(hidden.dtype, wte.dtype)
    return FusedXentFn.apply(x2, wte, t, w_row, op_dtype)


class FusedXentFn(torch.autograd.Function):
    """Twin of the custom VJP ``_fused`` (``:386-440``)."""

    @staticmethod
    def forward(ctx, x2, wte, t, w_row, compute_dtype):
        xc, wc = x2.to(compute_dtype), wte.to(compute_dtype)
        lse, tgt = xent_fwd(xc, wc, t)
        w_sum = w_row.sum().clamp_min(1.0)
        ctx.save_for_backward(xc, wc, t, w_row, lse, w_sum)
        ctx.dtypes = (x2.dtype, wte.dtype)
        return ((lse - tgt) * w_row).sum() / w_sum

    @staticmethod
    def backward(ctx, g):
        xc, wc, t, w_row, lse, w_sum = ctx.saved_tensors
        c = (g * w_row / w_sum).to(torch.float32)
        dx = xent_dx(xc, wc, t, lse, c).to(ctx.dtypes[0])
        dw = xent_dw(xc, wc, t, lse, c).to(ctx.dtypes[1])
        return dx, dw, None, torch.zeros_like(w_row), None


def vocab_parallel_xent(hidden: torch.Tensor, wte: torch.Tensor,
                        targets: torch.Tensor, mask=None, *, shard,
                        compute_dtype=None, kernels: bool = True
                        ) -> torch.Tensor:
    """:func:`fused_softmax_xent` with the tied table split by rows over
    a ``model`` group: ``wte`` is this rank's rows ``[shard.offset,
    shard.offset + rows)`` of ``shard.vocab`` (a
    ``models.layers.VocabShard``), ``hidden`` the whole (replicated)
    hidden states.  Each rank runs K4f on its rows with the targets moved
    by the offset (a target outside the rows matches none: its target
    logit is 0); the ranks' lse combine through an all-reduce of the max
    and one of the sums of exponentials, the target logits through a sum.
    The backward runs K4b dx and dw on the rows with that global lse: dw
    is this rank's rows' gradient, dx a partial sum the ranks add up.
    ``kernels=False`` (the chunked heads) takes the plain twins on any
    device, over tiles of tokens so that the (N, V/ranks) logits never
    exist whole."""
    v, d = wte.shape
    x2 = hidden.reshape(-1, d)
    n = x2.shape[0]
    t = targets.reshape(n).to(torch.int32)
    w_row = (torch.ones(n, dtype=torch.float32, device=hidden.device)
             if mask is None else mask.reshape(n).to(torch.float32))
    w_row = w_row * ((t >= 0) & (t < shard.vocab)).to(torch.float32)
    op_dtype = compute_dtype or torch.promote_types(hidden.dtype, wte.dtype)
    return VocabParallelXentFn.apply(x2, wte, t - shard.offset, w_row,
                                     op_dtype, shard.group, kernels)


class VocabParallelXentFn(torch.autograd.Function):
    """The head of :func:`vocab_parallel_xent` (GSPMD's values for the
    vocab-sharded table of ``gpt_layout``)."""

    @staticmethod
    def forward(ctx, x2, wte, t_local, w_row, compute_dtype, group,
                kernels):
        from ..parallel.collectives import ReduceOp, all_reduce

        xc, wc = x2.to(compute_dtype), wte.to(compute_dtype)
        fwd = xent_fwd if kernels else _xent_fwd_tiles
        lse_r, tgt_r = fwd(xc, wc, t_local)
        m = all_reduce(lse_r, group, ReduceOp.MAX)
        lse = m + torch.log(all_reduce(torch.exp(lse_r - m), group))
        tgt = all_reduce(tgt_r, group)
        w_sum = w_row.sum().clamp_min(1.0)
        ctx.save_for_backward(xc, wc, t_local, w_row, lse, w_sum)
        ctx.dtypes = (x2.dtype, wte.dtype)
        ctx.group, ctx.kernels = group, kernels
        return ((lse - tgt) * w_row).sum() / w_sum

    @staticmethod
    def backward(ctx, g):
        from ..parallel.collectives import all_reduce

        xc, wc, t, w_row, lse, w_sum = ctx.saved_tensors
        c = (g * w_row / w_sum).to(torch.float32)
        if ctx.kernels:
            dx, dw = xent_dx(xc, wc, t, lse, c), xent_dw(xc, wc, t, lse, c)
        else:
            dx, dw = _xent_bwd_tiles(xc, wc, t, lse, c)
        dx = all_reduce(dx, ctx.group)
        return (dx.to(ctx.dtypes[0]), dw.to(ctx.dtypes[1]), None,
                torch.zeros_like(w_row), None, None, None)


def xent_fwd(x, w, t):
    """``(lse, tgt)``, both (N,) fp32: K4f for CUDA tensors, the plain
    twin for CPU ones."""
    if x.device.type == "cpu":
        return xent_fwd_plain(x, w, t)
    return xent_fwd_cuda(x, w, t)


def xent_dx(x, w, t, lse, c):
    """dx (N, D) fp32: K4b dx for CUDA tensors, the plain twin for CPU
    ones."""
    if x.device.type == "cpu":
        return xent_dx_plain(x, w, t, lse, c)
    return xent_dx_cuda(x, w, t, lse, c)


def xent_dw(x, w, t, lse, c):
    """dw (V, D) fp32: K4b dw for CUDA tensors, the plain twin for CPU
    ones."""
    if x.device.type == "cpu":
        return xent_dw_plain(x, w, t, lse, c)
    return xent_dw_cuda(x, w, t, lse, c)


# --------------------------------------------------------------- plain twins


def _logits(x, w):
    """(N, V) fp32 logits of the rounded operands, fp32 products."""
    return x.float() @ w.float().T


def xent_fwd_plain(x, w, t):
    """Per-token ``lse`` and target logit (0 for a target outside
    [0, V)), (N,) fp32 each (``_fwd_kernel``)."""
    v = w.shape[0]
    logits = _logits(x, w)
    t = t.long()
    valid = (t >= 0) & (t < v)
    tgt = logits.gather(1, t.clamp(0, v - 1)[:, None])[:, 0]
    return torch.logsumexp(logits, dim=-1), torch.where(valid, tgt, 0.0)


def _dlog(x, w, t, lse, c):
    """``c * (exp(logit - lse) - onehot)`` rounded to the operand dtype,
    widened back to fp32."""
    logits = _logits(x, w)
    onehot = torch.arange(w.shape[0], device=x.device)[None, :] \
        == t.long()[:, None]
    p = torch.exp(logits - lse[:, None])
    return (c[:, None] * (p - onehot.float())).to(w.dtype).float()


def _xent_fwd_tiles(x, w, t):
    """:func:`xent_fwd_plain` over tiles of
    ``ops.xent.DEFAULT_CHUNK_TOKENS`` tokens: one (C, V) fp32 logits
    tile alive at a time, the memory bound of the chunked head."""
    step = DEFAULT_CHUNK_TOKENS
    tiles = [xent_fwd_plain(x[lo:lo + step], w, t[lo:lo + step])
             for lo in range(0, x.shape[0], step)]
    return (torch.cat([lse for lse, _ in tiles]),
            torch.cat([tgt for _, tgt in tiles]))


def _xent_bwd_tiles(x, w, t, lse, c):
    """``(dx, dw)`` of :func:`xent_dx_plain` and :func:`xent_dw_plain`
    over the tiles of :func:`_xent_fwd_tiles`, each tile's dlog made
    once for both products; dw sums the tiles' products."""
    step = DEFAULT_CHUNK_TOKENS
    dx = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    dw = torch.zeros(w.shape, dtype=torch.float32, device=x.device)
    for lo in range(0, x.shape[0], step):
        rows = slice(lo, lo + step)
        dlog = _dlog(x[rows], w, t[rows], lse[rows], c[rows])
        dx[rows] = dlog @ w.float()
        dw += dlog.T @ x[rows].float()
    return dx, dw


def xent_dx_plain(x, w, t, lse, c):
    """dx = dlog . w, fp32 (``_bwd_dx_kernel``)."""
    return _dlog(x, w, t, lse, c) @ w.float()


def xent_dw_plain(x, w, t, lse, c):
    """dw = dlog^T . x, fp32 (``_bwd_dw_kernel``)."""
    return _dlog(x, w, t, lse, c).T @ x.float()


# ------------------------------------------------------------------- kernels


class XentFwdPlan(NamedTuple):
    """How ``csrc/fused_xent_fwd.cu`` cuts one K4f launch."""

    variant: str   # "wgmma" (bf16) or "fma" (fp32, CUDA cores)
    m: int         # tokens of a block
    tile: int      # vocab rows of a tile
    stages: int    # ring depth of the staged chunks
    cluster: int   # blocks of a cluster (1: no block shares a w chunk)
    threads: int   # threads of a block
    smem: int      # dynamic shared memory of a block, bytes
    grid: int      # blocks


_FWD_M, _FWD_TILE, _FWD_THREADS = 128, 256, 384  # bf16 (kM, kTile, kThreadsWg)
_FWD_STAGES = 4                                   # bf16 (kStages)
_FWD_FMA_M, _FWD_FMA_TILE = 64, 128               # fp32 (kOwn, kStream)


def xent_fwd_plan(n: int, v: int, d: int,
                  dtype=torch.bfloat16) -> XentFwdPlan:
    """The launch plan of K4f for ``n`` tokens against a vocabulary of
    ``v`` rows at hidden size ``d`` (any multiple of 64).

    bf16: a block of two consumer warpgroups and a producer warpgroup
    owns 128 tokens and sweeps the vocabulary in tiles of 256 rows,
    contracting over ``d`` in chunks of 64 columns that a ring of TMA
    stages brings in; a stage is the x chunk and the w chunk (128 + 256
    rows of 128 bytes) with its full and empty barriers, four stages after
    1 KB to align the base; the grid is ``ceil(n / 128)`` blocks, no
    cluster (two blocks sharing each w chunk by TMA multicast measured
    slower on the H100).
    fp32: the CUDA-core kernel, 64 tokens a block, tiles of 128 rows
    staged two chunks deep with 16 bytes of padding a row."""
    if n < 1 or v < 1:
        raise ValueError(f"empty operand: {n} tokens, {v} vocab rows")
    if d < 64 or d % 64:
        raise ValueError(f"K4f takes hidden sizes that are multiples of 64, "
                         f"got {d}")
    if dtype == torch.float32:
        smem = 4 * 2 * (_FWD_FMA_M + _FWD_FMA_TILE) * (64 + 4)
        blocks = -(-n // _FWD_FMA_M)
        return XentFwdPlan("fma", _FWD_FMA_M, _FWD_FMA_TILE, 2, 1, 256,
                           smem, blocks)
    if dtype != torch.bfloat16:
        raise TypeError(f"K4f takes bf16 or fp32, got {dtype}")
    stage = (_FWD_M + _FWD_TILE) * 128 + 16  # and its full and empty barriers
    return XentFwdPlan("wgmma", _FWD_M, _FWD_TILE, _FWD_STAGES, 1,
                       _FWD_THREADS, 1024 + _FWD_STAGES * stage,
                       -(-n // _FWD_M))


class XentBwdPlan(NamedTuple):
    """How ``csrc/fused_xent_bwd.cu`` cuts one K4b launch."""

    variant: str   # "wgmma_cluster" (bf16) or "fma" (fp32, CUDA cores)
    k: int         # blocks of a cluster, each owning D / k output columns
    m: int         # owned rows of a cluster
    s: int         # streamed rows of a tile
    stages: int    # ring depth of the streamed tiles
    threads: int   # threads of a block
    smem: int      # dynamic shared memory of a block, bytes
    clusters: int  # clusters (groups of m owned rows)
    grid: int      # blocks: clusters * k


_M, _S, _THREADS = 128, 64, 256      # bf16 kernel (kM, kS, kWgThreads)
_FMA_M, _FMA_S, _FMA_SC = 32, 128, 16  # fp32 kernel (kOwn, kStream, kSC)


def xent_bwd_plan(n_own: int, n_str: int, d: int,
                  dtype=torch.bfloat16) -> XentBwdPlan:
    """The launch plan of K4b for ``n_own`` owned rows (tokens for dx,
    vocab rows for dw) streaming ``n_str`` rows at hidden size ``d``.

    bf16: a cluster of ``k`` blocks owns 128 rows; block ``r`` holds the
    output columns ``[r d/k, (r+1) d/k)``, ``d/k`` the widest of 256 and
    128 that divides ``d`` (the gradient product runs in n128 pieces),
    as a 128 x d/k fp32 tile over 256 threads.  Its shared memory
    (``Layout`` in the source) is the owned slice, a ring of 64-row
    streamed slices (as many stages as fit, at most 4), when ``k > 1``
    the fp32 partial logits the cluster's blocks send to this one (``k``
    sources x ``ceil(8 / k)`` fragment chunks x 256 threads x 16 bytes),
    the bf16 dlog tile, per warpgroup two tiles' per-token (lse, c,
    t), the barriers (a full and an empty one a stage, the owned
    slice's, two a warpgroup for the exchange) and 1 KB to align the
    base.
    fp32: the CUDA-core kernel, 32 owned rows a block, no cluster."""
    if n_own < 1 or n_str < 1:
        raise ValueError(f"empty operand: {n_own} owned, {n_str} streamed rows")
    if d not in HIDDEN_SIZES:
        raise ValueError(f"K4b is built for hidden sizes {HIDDEN_SIZES}, "
                         f"got {d}")
    if dtype == torch.float32:
        pad = 4
        stage = max(2 * (_FMA_M + _FMA_S) * (64 + pad),
                    2 * _FMA_SC * (d + pad))
        smem = 4 * (stage + _FMA_M * (_FMA_S + pad))
        clusters = -(-n_own // _FMA_M)
        return XentBwdPlan("fma", 1, _FMA_M, _FMA_S, 2, 256, smem,
                           clusters, clusters)
    if dtype != torch.bfloat16:
        raise TypeError(f"K4b takes bf16 or fp32, got {dtype}")
    dk = next(w for w in (256, 128) if d % w == 0)
    k = d // dk
    recv = k * -(-8 // k) * _THREADS * 16 if k > 1 else 0
    fixed = 1024 + _M * dk * 2 + recv + _M * _S * 2 + 2 * 2 * 3 * _S * 4 + 40
    stage = _S * dk * 2 + 16  # and its full and empty barriers
    stages = min(4, (SMEM_LIMIT - fixed) // stage)
    if stages < 2:
        raise ValueError(f"D={d}: no two-stage ring fits {SMEM_LIMIT} bytes")
    clusters = -(-n_own // _M)
    return XentBwdPlan("wgmma_cluster", k, _M, _S, stages, _THREADS,
                       fixed + stages * stage, clusters, clusters * k)


def _operands(x, w, t, what, rows=()):
    """Check what the kernels take; returns the operands contiguous and
    16-byte aligned (a copy only where they are not)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} kernel needs CUDA tensors, got {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32) or w.dtype != x.dtype:
        raise TypeError(f"{what} kernel takes x and w both bf16 or both fp32, "
                        f"got {x.dtype} and {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1] \
            or x.shape[0] < 1 or w.shape[0] < 1:
        raise ValueError(f"{what} kernel needs x (N, D) and w (V, D), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    n, d = x.shape
    if d % 64 or (what != "fused_xent_fwd" and d not in HIDDEN_SIZES):
        raise ValueError(f"{what} kernel is built for hidden sizes "
                         f"{HIDDEN_SIZES}, got {d}")
    if t.shape != (n,) or t.dtype != torch.int32:
        raise ValueError(f"{what}: targets must be int32 (N,) = ({n},), got "
                         f"{t.dtype} {tuple(t.shape)}")
    for name, r in rows:
        if r.shape != (n,) or r.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be fp32 (N,) = ({n},), "
                             f"got {r.dtype} {tuple(r.shape)}")
    out = []
    for a in (x, w, t, *(r for _, r in rows)):
        if a.device != x.device:
            raise ValueError(f"{what}: operands on {x.device} and {a.device}")
        a = a.contiguous()
        out.append(a.clone() if a.data_ptr() % 16 else a)
    return out


def xent_fwd_cuda(x, w, t):
    """Launch ``csrc/fused_xent_fwd.cu`` on the current stream with the
    plan of :func:`xent_fwd_plan`; returns ``(lse, tgt)``.

    The port of ``_fwd_kernel``
    (``distributedtensorflow_tpu/ops/fused_xent.py:136``).  Bound on the
    H100 by operations: ``2 N V D`` flops over 989 TFLOP/s in bf16."""
    x, w, t = _operands(x, w, t, "fused_xent_fwd")
    (n, d), v = x.shape, w.shape[0]
    plan = xent_fwd_plan(n, v, d, x.dtype)
    lse = torch.empty(n, dtype=torch.float32, device=x.device)
    tgt = torch.empty(n, dtype=torch.float32, device=x.device)
    lib = _cuda.load("fused_xent_fwd", _FWD_SIGNATURES)
    err = lib.dtf_xent_fwd(
        x.data_ptr(), w.data_ptr(), t.data_ptr(), lse.data_ptr(),
        tgt.data_ptr(), n, v, d, x.dtype == torch.bfloat16, plan.m,
        plan.tile, plan.stages, plan.cluster, plan.threads, plan.smem,
        x.device.index or 0, _cuda.stream_handle(x.device))
    _cuda.launches["fused_xent_fwd"] += 1
    _cuda.check(lib, err, "fused_xent_fwd")
    return lse, tgt


def _bwd_cuda(x, w, t, lse, c, which):
    name = f"fused_xent_{which}"
    x, w, t, lse, c = _operands(x, w, t, name, (("lse", lse), ("c", c)))
    (n, d), v = x.shape, w.shape[0]
    rows, streamed = (n, v) if which == "dx" else (v, n)
    plan = xent_bwd_plan(rows, streamed, d, x.dtype)
    out = torch.empty((rows, d), dtype=torch.float32, device=x.device)
    lib = _cuda.load("fused_xent_bwd", _BWD_SIGNATURES)
    err = getattr(lib, f"dtf_xent_bwd_{which}")(
        x.data_ptr(), w.data_ptr(), t.data_ptr(), lse.data_ptr(),
        c.data_ptr(), out.data_ptr(), n, v, d, x.dtype == torch.bfloat16,
        plan.k, plan.m, plan.s, plan.stages, plan.smem,
        x.device.index or 0, _cuda.stream_handle(x.device))
    _cuda.launches[name] += 1
    _cuda.check(lib, err, name)
    return out


def xent_dx_cuda(x, w, t, lse, c):
    """Launch the dx kernel of ``csrc/fused_xent_bwd.cu``; returns dx
    (N, D) fp32.

    The port of ``_bwd_dx_kernel``
    (``distributedtensorflow_tpu/ops/fused_xent.py:180``).  Bound by
    operations: two products (the logits and dlog . w) of ``2 N V D``
    flops."""
    return _bwd_cuda(x, w, t, lse, c, "dx")


def xent_dw_cuda(x, w, t, lse, c):
    """Launch the dw kernel of ``csrc/fused_xent_bwd.cu``; returns dw
    (V, D) fp32.

    The port of ``_bwd_dw_kernel``
    (``distributedtensorflow_tpu/ops/fused_xent.py:214``).  Bound by
    operations: two products (the logits and dlog^T . x) of ``2 N V D``
    flops."""
    return _bwd_cuda(x, w, t, lse, c, "dw")
