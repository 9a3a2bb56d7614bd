"""Shared layers of the port's models.

Twin of ``distributedtensorflow_tpu/models/layers.py``: the LayerNorm
module, the dense-layer picker and dropout.  Parameters are kept in fp32
as flax keeps them (``param_dtype``); each call casts to the compute
dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.layernorm import layer_norm


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
    """flax ``nn.Dense(dtype=..., use_bias=False)``: an fp32 (out, in)
    weight, both operands cast to the compute dtype for the product.
    The GPT layers have no bias; biased layers come with the models that
    use them."""

    def __init__(self, in_features: int, out_features: int, *, dtype,
                 device=None):
        super().__init__(in_features, out_features, bias=False,
                         device=device, dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt))


def dense(in_features: int, features: int, *, dtype, quant: str | None = None,
          device=None) -> Dense:
    """The dense-layer picker.  Only full-width layers are ported; the
    quantised modes (int8, int8_stochastic, fp8) come in a later slice."""
    if quant and quant != "none":
        raise NotImplementedError(
            f"quant={quant!r}: quantised dense layers are not ported yet "
            "(ROADMAP.md)")
    return Dense(in_features, features, dtype=dtype, device=device)


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
