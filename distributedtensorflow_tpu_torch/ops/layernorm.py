"""LayerNorm over the last axis: fp32 statistics, one output rounding.

Twin of ``distributedtensorflow_tpu/ops/layernorm.py``.  :func:`layer_norm`
sends a CUDA tensor to the hand-written kernel ``csrc/layernorm_fwd.cu``
(the port of the TPU kernel ``_ln_fwd_kernel``, ``ops/layernorm.py:48``)
and a CPU tensor to :func:`_plain_layer_norm`, the PyTorch twin of
``_xla_layer_norm`` (``:162-172``) that the kernel is checked against.
The kernel is bound by bytes: its floor on the H100 is
``(N*D*(in + out) + 8*D) bytes / 3.35 TB/s``.

When a gradient is wanted, :class:`LayerNormFn` (the twin of the custom
VJP ``_fused_ln``, ``:105-159``) saves ``(x, scale)`` and its backward
recomputes the statistics: on the card through ``csrc/layernorm_bwd.cu``
(the port of ``_ln_bwd_kernel``, ``:59``), on the CPU through
:func:`_plain_layer_norm_bwd`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _cuda

_DTYPES = (torch.float32, torch.bfloat16)
#: Widest row the kernel holds in registers (16 vectors of 16 bytes a lane).
MAX_D = 2048
_SIGNATURES = {"dtf_layernorm_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
               + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]}
#: Widest row the backward kernel holds in registers (x and dy, 4 chunks
#: of 8 elements a lane each).
MAX_D_BWD = 1024
#: Blocks of the backward kernel's main pass that one SM holds (16 warps
#: each, at most 64 registers a thread: ``kBlocksPerSm`` in
#: ``csrc/layernorm_bwd.cu``).
BWD_BLOCKS_PER_SM = 2
_BWD_ROWS_PER_BLOCK = 16  # one warp a row
_BWD_SIGNATURES = {"dtf_layernorm_bwd": [ctypes.c_void_p] * 7
                   + [ctypes.c_int] * 3 + [ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p]}


def _plain_layer_norm(x, scale, bias, eps, out_dtype):
    """fp32 mean and centred variance, normalise, scale and shift, one
    rounding to ``out_dtype`` (``_xla_layer_norm``)."""
    xf = x.float()
    d = x.shape[-1]
    mean = xf.sum(-1, keepdim=True) / d
    xc = xf - mean
    var = (xc * xc).sum(-1, keepdim=True) / d
    y = xc * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(out_dtype)


def _plain_layer_norm_bwd(x, scale, dy, eps):
    """``(dx, dscale, dbias)`` of :func:`_plain_layer_norm` for an output
    cotangent ``dy``, by the formulas of ``_ln_bwd_kernel``: statistics
    recomputed from ``x`` (N, D), everything in fp32, ``dx`` rounded to
    ``x.dtype``, ``dscale``/``dbias`` fp32 sums over the rows."""
    xf = x.float()
    d = x.shape[-1]
    mean = xf.sum(-1, keepdim=True) / d
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).sum(-1, keepdim=True) / d + eps)
    xhat = xc * rstd
    dyf = dy.float()
    a = dyf * scale.float()
    c1 = a.sum(-1, keepdim=True) / d
    c2 = (a * xhat).sum(-1, keepdim=True) / d
    dx = (rstd * (a - c1 - xhat * c2)).to(x.dtype)
    return dx, (dyf * xhat).sum(0), dyf.sum(0)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
               eps: float = 1e-6, out_dtype=None) -> torch.Tensor:
    """LayerNorm of ``x`` (..., D) with fp32 ``scale``/``bias`` (D,).

    ``eps`` defaults to flax's 1e-6, not torch's 1e-5.  ``out_dtype=None``
    keeps ``x.dtype``.  Differentiable in ``x``, ``scale`` and ``bias``
    through :class:`LayerNormFn` when autograd records; otherwise the
    forward alone runs."""
    out_dtype = out_dtype or x.dtype
    if torch.is_grad_enabled() and (
            x.requires_grad or scale.requires_grad or bias.requires_grad):
        return LayerNormFn.apply(x, scale, bias, eps, out_dtype)
    return _forward(x, scale, bias, eps, out_dtype)


def _forward(x, scale, bias, eps, out_dtype):
    if x.device.type == "cpu":
        return _plain_layer_norm(x, scale, bias, eps, out_dtype)
    return layer_norm_cuda(x, scale, bias, eps, out_dtype)


def layer_norm_bwd(x, scale, dy, eps):
    """The backward of :func:`layer_norm` on rows ``x`` (N, D): the kernel
    for a CUDA tensor, :func:`_plain_layer_norm_bwd` for a CPU one."""
    if x.device.type == "cpu":
        return _plain_layer_norm_bwd(x, scale, dy, eps)
    return layer_norm_bwd_cuda(x, scale, dy, eps)


class LayerNormFn(torch.autograd.Function):
    """Twin of the custom VJP ``_fused_ln``: residuals ``(x, scale)``,
    the statistics recomputed in the backward.  ``dscale``/``dbias`` come
    back fp32, cast to the parameters' dtype as JAX does (``:155``)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, out_dtype):
        ctx.eps = eps
        ctx.bias_dtype = bias.dtype
        ctx.save_for_backward(x, scale)
        return _forward(x, scale, bias, eps, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        d = x.shape[-1]
        dx, dscale, dbias = layer_norm_bwd(
            x.reshape(-1, d).contiguous(), scale,
            dy.reshape(-1, d).contiguous(), ctx.eps)
        return (dx.reshape(x.shape), dscale.to(scale.dtype),
                dbias.to(ctx.bias_dtype), None, None)


def layer_norm_cuda(x, scale, bias, eps, out_dtype):
    """Launch ``csrc/layernorm_fwd.cu`` on ``x``'s current stream.

    The port of ``_ln_fwd_kernel``
    (``distributedtensorflow_tpu/ops/layernorm.py:48``).  Bound on the
    H100 by bytes, ``N * D * (in + out) + 8 * D`` over 3.35 TB/s; at the
    decode step's few rows, by launch latency."""
    d = x.shape[-1]
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(
            f"layer_norm kernel takes fp32/bf16, got {x.dtype} -> {out_dtype}")
    if not x.is_contiguous():
        raise ValueError("layer_norm kernel needs a contiguous input")
    if d > MAX_D or (d * x.element_size()) % 16:
        raise ValueError(
            f"layer_norm kernel needs D <= {MAX_D} in whole 16-byte vectors, "
            f"got D={d} of {x.dtype}")
    for name, p in (("scale", scale), ("bias", bias)):
        if p.shape != (d,) or p.dtype != torch.float32 \
                or p.device != x.device or not p.is_contiguous():
            raise ValueError(
                f"layer_norm kernel needs a contiguous fp32 {name} of shape "
                f"({d},) on {x.device}, got {tuple(p.shape)} {p.dtype} "
                f"on {p.device}")
    n = x.numel() // d
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if n == 0:
        return y
    lib = _cuda.load("layernorm_fwd", _SIGNATURES)
    err = lib.dtf_layernorm_fwd(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), n, d,
        eps, x.dtype == torch.bfloat16, out_dtype == torch.bfloat16,
        x.device.index or 0, _cuda.stream_handle(x.device))
    _cuda.launches["layernorm_fwd"] += 1
    _cuda.check(lib, err, "layernorm_fwd")
    return y


def bwd_blocks(n: int, sms: int) -> int:
    """Blocks of K1b's main pass for ``n`` rows on a card of ``sms`` SMs:
    one wave of ``BWD_BLOCKS_PER_SM`` blocks an SM, fewer where the rows
    (16 a block at a time) run out.  Each block writes one row of the
    ``(blocks, 2, D)`` dgamma/dbeta partials."""
    return max(1, min(-(-n // _BWD_ROWS_PER_BLOCK), sms * BWD_BLOCKS_PER_SM))


def bwd_workspace(n: int, d: int, sms: int, device) -> torch.Tensor:
    """The (blocks, 2, D) fp32 dgamma/dbeta partials of K1b's main pass,
    one row a block of :func:`bwd_blocks`."""
    return torch.empty((bwd_blocks(n, sms), 2, d), dtype=torch.float32,
                       device=device)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def layer_norm_bwd_cuda(x, scale, dy, eps):
    """Launch ``csrc/layernorm_bwd.cu`` on ``x``'s current stream:
    ``x`` (N, D) and ``dy`` (N, D) bf16/fp32, ``scale`` (D,) fp32; returns
    ``(dx in x.dtype, dscale fp32, dbias fp32)``.

    The port of ``_ln_bwd_kernel``
    (``distributedtensorflow_tpu/ops/layernorm.py:59``).  Bound on the
    H100 by bytes, ``N * D * (x + dy + dx) + 12 * D`` over 3.35 TB/s."""
    if x.device.type != "cuda":
        raise ValueError(
            f"layer_norm_bwd_cuda needs a CUDA tensor, got {x.device}")
    if x.dim() != 2 or dy.shape != x.shape:
        raise ValueError(f"layer_norm backward kernel takes x and dy of one "
                         f"(N, D) shape, got {tuple(x.shape)} and "
                         f"{tuple(dy.shape)}")
    if x.dtype not in _DTYPES or dy.dtype not in _DTYPES:
        raise TypeError(f"layer_norm backward kernel takes fp32/bf16, got x "
                        f"{x.dtype}, dy {dy.dtype}")
    n, d = x.shape
    if d > MAX_D_BWD or d % 8:
        raise ValueError(f"layer_norm backward kernel needs D <= {MAX_D_BWD} "
                         f"in whole chunks of 8, got D={d}")
    for t in (x, dy):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("layer_norm backward kernel needs contiguous, "
                             "16-byte aligned x and dy on one device")
    if scale.shape != (d,) or scale.dtype != torch.float32 \
            or scale.device != x.device or not scale.is_contiguous():
        raise ValueError(f"layer_norm backward kernel needs a contiguous "
                         f"fp32 scale of shape ({d},) on {x.device}")
    dx = torch.empty_like(x)
    dscale = torch.empty(d, dtype=torch.float32, device=x.device)
    dbias = torch.empty(d, dtype=torch.float32, device=x.device)
    if n == 0:
        return dx, dscale.zero_(), dbias.zero_()
    partial = bwd_workspace(n, d, _sm_count(x.device.index or 0), x.device)
    blocks = partial.shape[0]
    lib = _cuda.load("layernorm_bwd", _BWD_SIGNATURES)
    err = lib.dtf_layernorm_bwd(
        x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        partial.data_ptr(), dscale.data_ptr(), dbias.data_ptr(), n, d,
        blocks, eps, x.dtype == torch.bfloat16, dy.dtype == torch.bfloat16,
        x.device.index or 0, _cuda.stream_handle(x.device))
    _cuda.launches["layernorm_bwd"] += 1
    _cuda.check(lib, err, "layernorm_bwd")
    return dx, dscale, dbias
