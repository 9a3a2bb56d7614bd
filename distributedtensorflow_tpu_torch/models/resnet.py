"""ResNets: ResNet-20 (``cifar_resnet20``) and ResNet-50
(``imagenet_resnet50``).

Twin of ``distributedtensorflow_tpu/models/resnet.py`` (``:23-154``):
the basic and v1.5 bottleneck blocks, bf16 compute with fp32 parameters
and batch statistics, NHWC inputs.  A model takes the NHWC batch and
moves the channels to dim 1 once at its entry, a view that on the card is
the ``channels_last`` memory format cuDNN runs fastest (the models'
weights are made ``channels_last`` there too).  The convolutions go to
cuDNN and BatchNorm to :class:`layers.BatchNorm` (see there for flax's
semantics), as XLA runs both on the TPU.

flax's ``"SAME"`` pads a stride-2 3x3 conv on an even input (0, 1)
(:func:`layers.same_padding`); the ResNet-50 stem pads (3, 3), its
space-to-depth variant (2, 1), and the max-pool pads with -inf.  The last
BatchNorm of every block starts at scale 0.  Submodules carry the flax
tree's names (``Conv_0``, ``BatchNorm_1``, ``ResidualBlock_4``, ...), so
a parameter's or buffer's name is its flax path.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .layers import BatchNorm, Conv, Dense


@dataclasses.dataclass(frozen=True)
class CifarResNetConfig:
    """ResNet-6n+2 for CIFAR (n=3: ResNet-20)."""

    num_classes: int = 10
    n: int = 3
    dtype: torch.dtype = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class ImageNetResNetConfig:
    """Bottleneck ResNet; ``stage_sizes`` (3, 4, 6, 3): ResNet-50.
    ``space_to_depth`` packs 2x2 pixels into channels and runs the stem as
    a 4x4 stride-1 conv (the JAX class's docstring, ``:101-118``)."""

    num_classes: int = 1000
    stage_sizes: tuple[int, ...] = (3, 4, 6, 3)
    dtype: torch.dtype = torch.bfloat16
    space_to_depth: bool = False


class ResidualBlock(nn.Module):
    """Basic 3x3 + 3x3 block; a 1x1 conv and BatchNorm on the shortcut
    where the block changes the shape."""

    def __init__(self, in_features: int, filters: int, strides: int, dtype,
                 device=None):
        super().__init__()
        kw = dict(use_bias=False, dtype=dtype, device=device)
        self.Conv_0 = Conv(in_features, filters, (3, 3), strides=strides,
                           **kw)
        self.BatchNorm_0 = BatchNorm(filters, device=device)
        self.Conv_1 = Conv(filters, filters, (3, 3), **kw)
        self.BatchNorm_1 = BatchNorm(filters, zero_scale=True, device=device)
        self.shortcut = strides != 1 or in_features != filters
        if self.shortcut:
            self.Conv_2 = Conv(in_features, filters, (1, 1), strides=strides,
                               **kw)
            self.BatchNorm_2 = BatchNorm(filters, device=device)

    def forward(self, x, train: bool):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.BatchNorm_1(self.Conv_1(y), train)
        if self.shortcut:
            x = self.BatchNorm_2(self.Conv_2(x), train)
        return F.relu(y + x)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 (x4) bottleneck, v1.5: the stride on the 3x3."""

    def __init__(self, in_features: int, filters: int, strides: int, dtype,
                 device=None):
        super().__init__()
        kw = dict(use_bias=False, dtype=dtype, device=device)
        out = filters * 4
        self.Conv_0 = Conv(in_features, filters, (1, 1), **kw)
        self.BatchNorm_0 = BatchNorm(filters, device=device)
        self.Conv_1 = Conv(filters, filters, (3, 3), strides=strides, **kw)
        self.BatchNorm_1 = BatchNorm(filters, device=device)
        self.Conv_2 = Conv(filters, out, (1, 1), **kw)
        self.BatchNorm_2 = BatchNorm(out, zero_scale=True, device=device)
        self.shortcut = strides != 1 or in_features != out
        if self.shortcut:
            self.Conv_3 = Conv(in_features, out, (1, 1), strides=strides,
                               **kw)
            self.BatchNorm_3 = BatchNorm(out, device=device)

    def forward(self, x, train: bool):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        if self.shortcut:
            x = self.BatchNorm_3(self.Conv_3(x), train)
        return F.relu(y + x)


class _ResNet(nn.Module):
    """The stages of blocks (registered as ``{kind}_{i}``), the mean over
    space and the fp32 ``Dense_0`` head shared by both nets."""

    def _add_blocks(self, kind, block_cls, in_features, widths, dtype,
                    device):
        """``widths``: (filters, strides) of each block in order."""
        self.block_names = []
        for i, (filters, strides) in enumerate(widths):
            name = f"{kind}_{i}"
            self.add_module(name, block_cls(in_features, filters, strides,
                                            dtype, device=device))
            self.block_names.append(name)
            in_features = filters * (4 if block_cls is BottleneckBlock else 1)
        self.Dense_0 = Dense(in_features, self.cfg.num_classes,
                             dtype=torch.float32, use_bias=True,
                             device=device)
        if device.type == "cuda":
            self.to(memory_format=torch.channels_last)

    @property
    def device(self) -> torch.device:
        return self.Dense_0.weight.device

    def _trunk(self, x, train: bool):
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        return self.Dense_0(x.mean((2, 3)))


class CifarResNet(_ResNet):
    """``forward(x, train=True)``: x (B, 32, 32, 3) NHWC -> fp32 logits.
    ``train=False`` normalises with the running statistics and leaves
    them as they are."""

    def __init__(self, cfg: CifarResNetConfig = CifarResNetConfig(), *,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.Conv_0 = Conv(3, 16, (3, 3), use_bias=False, dtype=cfg.dtype,
                           device=device)
        self.BatchNorm_0 = BatchNorm(16, device=device)
        widths = [(f, 2 if stage > 0 and block == 0 else 1)
                  for stage, f in enumerate((16, 32, 64))
                  for block in range(cfg.n)]
        self._add_blocks("ResidualBlock", ResidualBlock, 16, widths,
                         cfg.dtype, device)

    def forward(self, x, train: bool = True):
        x = x.to(self.cfg.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        return self._trunk(x, train)


class ImageNetResNet(_ResNet):
    """``forward(x, train=True)``: x (B, 224, 224, 3) NHWC -> fp32
    logits."""

    def __init__(self, cfg: ImageNetResNetConfig = ImageNetResNetConfig(),
                 *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        kw = dict(use_bias=False, dtype=cfg.dtype, device=device)
        if cfg.space_to_depth:
            self.Conv_0 = Conv(12, 64, (4, 4), padding=((2, 1), (2, 1)), **kw)
        else:
            self.Conv_0 = Conv(3, 64, (7, 7), strides=2,
                               padding=((3, 3), (3, 3)), **kw)
        self.BatchNorm_0 = BatchNorm(64, device=device)
        widths = [(64 * 2**stage, 2 if stage > 0 and block == 0 else 1)
                  for stage, size in enumerate(cfg.stage_sizes)
                  for block in range(size)]
        self._add_blocks("BottleneckBlock", BottleneckBlock, 64, widths,
                         cfg.dtype, device)

    def forward(self, x, train: bool = True):
        x = x.to(self.cfg.dtype)
        if self.cfg.space_to_depth:
            b, h, w, c = x.shape
            x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(
                0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        x = F.max_pool2d(x, 3, 2, padding=1)  # pads with -inf
        return self._trunk(x, train)


def ResNet20(*, device=None, **kw) -> CifarResNet:
    return CifarResNet(CifarResNetConfig(n=3, **kw), device=device)


def ResNet50(*, device=None, **kw) -> ImageNetResNet:
    return ImageNetResNet(ImageNetResNetConfig(stage_sizes=(3, 4, 6, 3),
                                               **kw), device=device)
