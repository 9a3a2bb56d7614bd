"""LayerNorm over the last axis: fp32 statistics, one output rounding.

Twin of ``distributedtensorflow_tpu/ops/layernorm.py``.  :func:`layer_norm`
sends a CUDA tensor to the hand-written kernel ``csrc/layernorm_fwd.cu``
(the port of the TPU kernel ``_ln_fwd_kernel``, ``ops/layernorm.py:48``)
and a CPU tensor to :func:`_plain_layer_norm`, the PyTorch twin of
``_xla_layer_norm`` (``:162-172``) that the kernel is checked against.
The kernel is bound by bytes: its floor on the H100 is
``(N*D*(in + out) + 8*D) bytes / 3.35 TB/s``.  Forward only: the
backward kernel (K1b) belongs to the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

_DTYPES = (torch.float32, torch.bfloat16)
#: Widest row the kernel holds in registers (16 vectors of 16 bytes a lane).
MAX_D = 2048
_SIGNATURES = {"dtf_layernorm_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
               + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]}


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


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
               eps: float = 1e-6, out_dtype=None) -> torch.Tensor:
    """LayerNorm of ``x`` (..., D) with fp32 ``scale``/``bias`` (D,).

    ``eps`` defaults to flax's 1e-6, not torch's 1e-5.  ``out_dtype=None``
    keeps ``x.dtype``."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return _plain_layer_norm(x, scale, bias, eps, out_dtype)
    return layer_norm_cuda(x, scale, bias, eps, out_dtype)


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
