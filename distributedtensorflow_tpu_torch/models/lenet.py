"""LeNet-5 for MNIST: the ``mnist_lenet`` preset's model.

Twin of ``distributedtensorflow_tpu/models/lenet.py`` (``:14-30``): two
conv + tanh + average-pool stages, then a 120-84-10 dense head, fp32.
Submodules carry the flax tree's names (``Conv_0`` ... ``Dense_2``), so a
parameter's name is its flax path (``models/convert.py``).  The JAX model
flattens NHWC feature maps, so the rows of ``Dense_0`` are in (h, w, c)
order: the port moves the channels last before the flatten.  The port
takes 28x28 inputs (MNIST, the preset's): torch needs ``Dense_0``'s
width when it builds the layer, where flax reads it off the first input.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .layers import Conv, Dense


#: Width of the flattened feature maps of a 28x28 input: 16 maps of 5x5.
_FLAT = 16 * 5 * 5


@dataclasses.dataclass(frozen=True)
class LeNetConfig:
    num_classes: int = 10
    dtype: torch.dtype = torch.float32


class LeNet5(nn.Module):
    """``forward(x, train=True)``: x (B, 28, 28, 1) NHWC -> fp32 logits
    (B, num_classes).  ``train`` is accepted for the classification
    losses' sake; LeNet has no batch statistics."""

    def __init__(self, cfg: LeNetConfig = LeNetConfig(), *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        dt = cfg.dtype
        self.Conv_0 = Conv(1, 6, (5, 5), padding="SAME", dtype=dt,
                           device=device)
        self.Conv_1 = Conv(6, 16, (5, 5), padding="VALID", dtype=dt,
                           device=device)
        self.Dense_0 = Dense(_FLAT, 120, dtype=dt, use_bias=True,
                             device=device)
        self.Dense_1 = Dense(120, 84, dtype=dt, use_bias=True, device=device)
        self.Dense_2 = Dense(84, cfg.num_classes, dtype=torch.float32,
                             use_bias=True, device=device)

    @property
    def device(self) -> torch.device:
        return self.Dense_2.weight.device

    def forward(self, x, train: bool = True):
        x = x.to(self.cfg.dtype).permute(0, 3, 1, 2)
        x = F.avg_pool2d(torch.tanh(self.Conv_0(x)), 2)
        x = F.avg_pool2d(torch.tanh(self.Conv_1(x)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (h, w, c) rows
        x = torch.tanh(self.Dense_0(x))
        x = torch.tanh(self.Dense_1(x))
        return self.Dense_2(x)
