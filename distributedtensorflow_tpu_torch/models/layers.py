"""Shared layers of the port's models.

Twin of ``distributedtensorflow_tpu/models/layers.py``: the LayerNorm
module, the dense-layer picker and dropout; and the flax layers that the
JAX models take from ``flax.linen`` directly: ``nn.Dense`` and
``nn.DenseGeneral`` (:class:`Dense`), ``nn.Conv`` with its ``"SAME"``
padding (:class:`Conv`) and ``nn.BatchNorm`` (:class:`BatchNorm`).
Parameters are kept in fp32 as flax keeps them (``param_dtype``); each
call casts to the compute dtype.  Convolutions take NCHW tensors (on the
card in the ``channels_last`` memory format, which is NHWC in memory).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.layernorm import layer_norm
from ..parallel.collectives import (
    all_gather,
    all_reduce,
    group_size,
    resolve_group,
    share_of_mean,
)


class FusedLayerNorm(nn.Module):
    """``nn.LayerNorm(dtype=float32)`` plus an output cast, through
    :func:`ops.layernorm.layer_norm` (the CUDA kernels K1f and, under
    autograd, K1b on the card).
    Parameters ``scale``/``bias`` (D,) in fp32; ``out_dtype=None`` keeps
    the input dtype, ``torch.float32`` feeds an fp32 head."""

    def __init__(self, features: int, *, eps: float = 1e-6, out_dtype=None,
                 device=None):
        super().__init__()
        self.eps = eps
        self.out_dtype = out_dtype
        self.scale = nn.Parameter(
            torch.ones(features, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(
            torch.zeros(features, dtype=torch.float32, device=device))

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias, eps=self.eps,
                          out_dtype=self.out_dtype or x.dtype)


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=...)``: an fp32 (out, in) weight and an
    optional fp32 bias, all operands cast to the compute dtype for the
    product.  The GPT layers have no bias.  ``kernel_shape`` and
    ``bias_shape`` are the flax parameters' shapes (``models/convert.py``
    reshapes to them): ``(in, out)`` and ``(out,)`` for ``nn.Dense``;
    an ``nn.DenseGeneral`` over heads keeps (E, H, D) or (H, D, E)
    kernels, which are the same matrix."""

    def __init__(self, in_features: int, out_features: int, *, dtype,
                 use_bias: bool = False, kernel_shape=None, bias_shape=None,
                 device=None):
        super().__init__(in_features, out_features, bias=use_bias,
                         device=device, dtype=torch.float32)
        self.compute_dtype = dtype
        self.kernel_shape = tuple(kernel_shape or (in_features, out_features))
        self.bias_shape = tuple(bias_shape or (out_features,))

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def dense(in_features: int, features: int, *, dtype, quant: str | None = None,
          use_bias: bool = False, device=None) -> Dense:
    """The dense-layer picker.  Only full-width layers are ported; the
    quantised modes (int8, int8_stochastic, fp8) come in a later slice."""
    if quant and quant != "none":
        raise NotImplementedError(
            f"quant={quant!r}: quantised dense layers are not ported yet "
            "(ROADMAP.md)")
    return Dense(in_features, features, dtype=dtype, use_bias=use_bias,
                 device=device)


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax ``"SAME"`` padding of one spatial dim: the output has
    ``ceil(size / stride)`` positions and an odd total pads one more
    after than before, so a stride-2 3x3 conv on an even size pads
    (0, 1) where ``nn.Conv2d(padding=1)`` pads (1, 1)."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv(dtype=...)`` on NCHW tensors: an fp32 (O, I, kh,
    kw) weight (flax's is (kh, kw, I, O)) and an optional fp32 bias, cast
    to the compute dtype.  ``padding`` is ``"SAME"`` (:func:`same_padding`
    for the input's size), ``"VALID"`` or ``((top, bottom), (left,
    right))``; an uneven pair is padded with zeros before the conv."""

    def __init__(self, in_features: int, features: int, kernel_size, *,
                 strides: int = 1, padding="SAME", use_bias: bool = True,
                 dtype, device=None):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.strides = strides
        self.padding = padding
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            features, in_features, *self.kernel_size, dtype=torch.float32,
            device=device))
        self.bias = nn.Parameter(torch.zeros(
            features, dtype=torch.float32, device=device)) \
            if use_bias else None

    def _pads(self, x):
        if self.padding == "SAME":
            return tuple(same_padding(n, k, self.strides) for n, k in
                         zip(x.shape[2:], self.kernel_size))
        if self.padding == "VALID":
            return (0, 0), (0, 0)
        return self.padding

    def forward(self, x):
        dt = self.compute_dtype
        (top, bottom), (left, right) = self._pads(x)
        x = x.to(dt)
        if top == bottom and left == right:
            pad = (top, left)
        else:
            x, pad = F.pad(x, (left, right, top, bottom)), 0
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x, self.weight.to(dt), bias, self.strides, pad)


def _plain_batch_norm(x, scale, bias, mean, var, train, momentum, eps,
                      group=None):
    """flax ``nn.BatchNorm`` over dim 1 of ``x``: with ``train`` the
    batch's fp32 statistics, the variance ``E[x^2] - E[x]^2`` clamped at
    0 (``use_fast_variance``), and the running ``mean``/``var`` updated
    in place to ``momentum * running + (1 - momentum) * batch`` with the
    biased variance; without, the running statistics.  Normalised in
    fp32, one rounding to ``x.dtype``.  With a data-parallel ``group``
    the batch is the global one: each rank's ``E[x]`` and ``E[x^2]``,
    weighted by its share of the rows, are summed over the ranks by a
    differentiable all-reduce, whose backward sums the two statistics'
    gradients over the ranks."""
    xf = x.float()
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if train:
        axes = [0] + list(range(2, x.dim()))
        mu, ex2 = xf.mean(axes), (xf * xf).mean(axes)
        if group is not None:
            share = share_of_mean(x.numel() // x.shape[1], group)
            mu, ex2 = all_reduce(torch.stack([mu, ex2]) * share, group)
        var_b = torch.clamp(ex2 - mu * mu, min=0.0)
        with torch.no_grad():
            mean.copy_(momentum * mean + (1 - momentum) * mu)
            var.copy_(momentum * var + (1 - momentum) * var_b)
    else:
        mu, var_b = mean, var
    mul = torch.rsqrt(var_b + eps) * scale
    return ((xf - mu.view(shape)) * mul.view(shape)
            + bias.view(shape)).to(x.dtype)


def batch_norm_cuda(x, scale, bias, mean, var, train, momentum, eps):
    """:func:`_plain_batch_norm` through ``F.batch_norm`` (cuDNN or
    PyTorch's CUDA kernel), as XLA runs flax's on the TPU.  Torch would
    keep the unbiased variance with momentum ``1 - momentum``: the batch
    statistics come out of a call with momentum 1 into zeroed tensors,
    and the running ones are updated here with the biased variance."""
    if not train:
        return F.batch_norm(x, mean, var, scale, bias, False, 0.0, eps)
    mu, var_u = torch.zeros_like(mean), torch.zeros_like(var)
    y = F.batch_norm(x, mu, var_u, scale, bias, True, 1.0, eps)
    n = x.numel() // x.shape[1]
    with torch.no_grad():
        mean.copy_(momentum * mean + (1 - momentum) * mu)
        var.copy_(momentum * var + (1 - momentum) * (var_u * ((n - 1) / n)))
    return y


def _dense_layout(t):
    """``t`` contiguous in its own memory format (the batch-norm kernels
    take NCHW or channels-last)."""
    if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last):
        return t
    return t.contiguous()


class _SyncBatchNormCuda(torch.autograd.Function):
    """The training forward and backward of :func:`batch_norm_cuda` over a
    data-parallel group's global batch, on PyTorch's batch-norm kernels
    (those of ``SyncBatchNorm``): per-rank mean and inverse deviation,
    gathered with the counts and merged (Welford); in the backward the
    two per-channel gradient sums all-reduced.  Returns ``(y, mean,
    invstd)``, the last two without gradient."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, group):
        x = _dense_layout(x)
        c = x.shape[1]
        mean, invstd = torch.batch_norm_stats(x, eps)
        count = torch.full((1,), x.numel() // c, dtype=mean.dtype,
                           device=x.device)
        table = all_gather(torch.cat([mean, invstd, count]), group,
                           tiled=False)
        counts = table[:, 2 * c]
        mean, invstd = torch.batch_norm_gather_stats_with_counts(
            x, table[:, :c], table[:, c:2 * c], None, None, 0.0, eps, counts)
        ctx.save_for_backward(x, scale, mean, invstd,
                              counts.to(torch.int32))
        ctx.group = group
        ctx.mark_non_differentiable(mean, invstd)
        return torch.batch_norm_elemt(x, scale, bias, mean, invstd, eps), \
            mean, invstd

    @staticmethod
    def backward(ctx, g, _mean, _invstd):
        x, scale, mean, invstd, counts = ctx.saved_tensors
        g = _dense_layout(g)
        sum_dy, sum_dy_xmu, dscale, dbias = torch.batch_norm_backward_reduce(
            g, x, mean, invstd, scale, True, True, True)
        sums = all_reduce(torch.cat([sum_dy, sum_dy_xmu]), ctx.group)
        sum_dy, sum_dy_xmu = sums.chunk(2)
        dx = torch.batch_norm_backward_elemt(g, x, mean, invstd, scale,
                                             sum_dy, sum_dy_xmu, counts)
        return dx, dscale, dbias, None, None


def sync_batch_norm_cuda(x, scale, bias, mean, var, momentum, eps, group):
    """:func:`batch_norm_cuda`'s training forward over the global batch of
    a data-parallel ``group`` (:class:`_SyncBatchNormCuda`), in fp32 with
    one rounding to ``x.dtype`` (the kernels' statistics merge takes its
    counts in the input's dtype), the running buffers updated with the
    biased variance as there."""
    y, mu, invstd = _SyncBatchNormCuda.apply(x.float(), scale, bias, eps,
                                             resolve_group(group))
    with torch.no_grad():
        mean.copy_(momentum * mean + (1 - momentum) * mu)
        var.copy_(momentum * var + (1 - momentum) * (invstd ** -2 - eps))
    return y.to(x.dtype)


#: flax ``nn.BatchNorm``'s settings in the ResNets (``resnet.py:33-36``).
BN_MOMENTUM = 0.9
BN_EPS = 1e-5


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5,
    param_dtype=float32)`` over the channels (dim 1): fp32 ``scale`` and
    ``bias``, and the running ``mean``/``var`` as buffers (flax's
    ``batch_stats``), updated once a training forward.  ``forward(x,
    train)``: :func:`_plain_batch_norm` on the CPU, :func:`batch_norm_cuda`
    on the card.  ``zero_scale`` marks the scale that flax starts at 0
    (``scale_init=zeros``), for ``init_params``.  ``group``: a
    data-parallel group (or mesh) of more than one rank makes a training
    forward take the global batch's statistics (flax's BatchNorm sees the
    global array): :func:`_plain_batch_norm` over the group on the CPU,
    :func:`sync_batch_norm_cuda` on the card."""

    def __init__(self, features: int, *, zero_scale: bool = False,
                 device=None, group=None):
        super().__init__()
        self.zero_scale = zero_scale
        self.group = group
        self.scale = nn.Parameter(torch.ones(features, dtype=torch.float32,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=torch.float32,
                                             device=device))
        self.register_buffer("mean", torch.zeros(
            features, dtype=torch.float32, device=device))
        self.register_buffer("var", torch.ones(
            features, dtype=torch.float32, device=device))

    def forward(self, x, train: bool):
        args = (x, self.scale, self.bias, self.mean, self.var, train,
                BN_MOMENTUM, BN_EPS)
        cpu = x.device.type == "cpu"
        if train and self.group is not None and group_size(self.group) > 1:
            if cpu:
                return _plain_batch_norm(*args, group=self.group)
            return sync_batch_norm_cuda(x, self.scale, self.bias, self.mean,
                                        self.var, BN_MOMENTUM, BN_EPS,
                                        self.group)
        return (_plain_batch_norm if cpu else batch_norm_cuda)(*args)


def dropout(x: torch.Tensor, rate: float, seed: int | None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability
    ``1 - rate`` and scale the kept ones by ``1 / (1 - rate)``.  The bits
    come from a generator on ``x``'s device seeded with ``seed``, so a
    recomputation (block remat) draws the same mask; ``seed=None`` or
    ``rate=0`` is the identity."""
    if seed is None or not rate:
        return x
    g = torch.Generator(device=x.device).manual_seed(seed)
    keep = torch.rand(x.shape, generator=g, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
