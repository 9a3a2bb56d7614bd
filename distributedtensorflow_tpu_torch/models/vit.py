"""Vision Transformer: the ``imagenet_vit`` preset's model.

Twin of ``distributedtensorflow_tpu/models/vit.py``: ``ViTConfig``
(``:27-46``), ``vit_s16`` and ``vit_tiny`` (``:49-58``), ``ViTBlock``
(``:61-94``) and ``ViT`` (``:97-131``).  The patch embedding is one
strided, biased :class:`~.layers.Conv` (flax ``"SAME"`` pads nothing when
the patch divides the image), on the card over ``channels_last`` weights
as the port's ResNets run theirs; an fp32 ``pos_embed`` (1, N, D) added
in the compute dtype; pre-LN blocks of :class:`~.layers.FusedLayerNorm`
(the kernels K1f and, under autograd, K1b on the card), a fused qkv
product without bias split in q/k/v order, bidirectional attention
through ``ops.attention.dot_product_attention`` (below the flash gate's
sequence length at every preset, so the plain path, as in JAX),
tanh-approximated GELU and dropout on the MLP output only; then ``ln_f``
with fp32 out, a mean over the tokens (no cls token) and an fp32 ``head``
with a bias.  Submodules carry the flax tree's names (``patch_embed``,
``block_{i}``, ``ln_f``, ``head``), so a parameter's name is its flax
path.  ``quant`` runs the four block products quantised
(``layers.QuantDense``); :func:`vit_layout` splits the blocks over a
``model`` axis.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.attention import dot_product_attention
from ..parallel.sharding import LayoutMap, P
from .layers import (
    Conv,
    Dense,
    FusedLayerNorm,
    bind_quant_seed,
    dense,
    draw_seed,
    dropout,
    number_quant_sites,
)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    hidden_size: int = 384      # ViT-S
    num_layers: int = 12
    num_heads: int = 6
    intermediate_size: int = 1536
    dropout_rate: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    #: Quantised block matmuls (``ops.quant``), or None.
    quant: str | None = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def vit_s16() -> ViTConfig:
    return ViTConfig()


def vit_tiny() -> ViTConfig:
    """Test-size: 32px/8px patches, 2 layers, 128 hidden."""
    return ViTConfig(image_size=32, patch_size=8, num_classes=10,
                     hidden_size=128, num_layers=2, num_heads=4,
                     intermediate_size=256)


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        e, f = cfg.hidden_size, cfg.intermediate_size
        kw = dict(dtype=cfg.dtype, quant=cfg.quant, device=device)
        self.ln1 = FusedLayerNorm(e, device=device)
        self.qkv = dense(e, 3 * e, **kw)
        self.qkv.segments = (e, e, e)  # tensor parallelism cuts head-major
        self.proj = dense(e, e, **kw)
        self.ln2 = FusedLayerNorm(e, device=device)
        self.fc_in = dense(e, f, **kw)
        self.fc_out = dense(f, e, **kw)

    def forward(self, x, seed=None):
        cfg = self.cfg
        b, s, e = x.shape
        h = self.ln1(x)
        qkv = self.qkv(h)  # this rank's heads over a model axis
        q, k, v = (t.reshape(b, s, -1, cfg.head_dim)
                   for t in qkv.split(qkv.shape[-1] // 3, dim=-1))
        x = x + self.proj(dot_product_attention(q, k, v).reshape(b, s, -1))
        h = self.fc_out(F.gelu(self.fc_in(self.ln2(x)), approximate="tanh"))
        return x + dropout(h, cfg.dropout_rate, seed)


class ViT(nn.Module):
    """ViT classifier: ``forward(images, train=False, generator=None)``,
    images (B, H, W, 3) NHWC -> fp32 logits (B, classes).  With ``train``
    and a dropout rate each block draws one seed from ``generator`` (the
    step's ``DropoutKey``).  Parameters live on ``device`` (``cuda``
    unless the caller passes ``"cpu"``)."""

    def __init__(self, cfg: ViTConfig = ViTConfig(), *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        e, p = cfg.hidden_size, cfg.patch_size
        self.patch_embed = Conv(3, e, (p, p), strides=p, use_bias=True,
                                dtype=cfg.dtype, device=device)
        self.pos_embed = nn.Parameter(torch.zeros(
            1, cfg.num_patches, e, dtype=torch.float32, device=device))
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", ViTBlock(cfg, device=device))
        self.ln_f = FusedLayerNorm(e, out_dtype=torch.float32,
                                   device=device)
        self.head = Dense(e, cfg.num_classes, dtype=torch.float32,
                          use_bias=True, device=device)
        number_quant_sites(self)
        if device.type == "cuda":
            self.to(memory_format=torch.channels_last)

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    def forward(self, images, train: bool = False, generator=None):
        cfg = self.cfg
        if tuple(images.shape[1:]) != (cfg.image_size, cfg.image_size, 3):
            raise ValueError(
                f"expected (B, {cfg.image_size}, {cfg.image_size}, 3) NHWC "
                f"input, got {tuple(images.shape)}")
        bind_quant_seed(self, generator if train else None)
        x = self.patch_embed(images.to(cfg.dtype).permute(0, 3, 1, 2))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, cfg.hidden_size)
        x = x + self.pos_embed.to(cfg.dtype)
        drop = train and cfg.dropout_rate > 0
        for i in range(cfg.num_layers):
            x = getattr(self, f"block_{i}")(
                x, draw_seed(generator) if drop else None)
        return self.head(self.ln_f(x).mean(dim=1))


def vit_layout() -> LayoutMap:
    """Megatron ``model``-axis rules (JAX ``vit_layout``,
    ``models/vit.py:134-142``): qkv and fc_in column-parallel, proj and
    fc_out row-parallel."""
    return LayoutMap([
        (r".*qkv/kernel", P(None, "model")),
        (r".*proj/kernel", P("model", None)),
        (r".*fc_in/kernel", P(None, "model")),
        (r".*fc_out/kernel", P("model", None)),
    ])
