"""BERT-MoE: the ``bert_moe`` preset's encoder with expert-choice routing.

Twin of ``distributedtensorflow_tpu/models/bert_moe.py``: BERT's
post-LN encoder (``models/bert.py``, through its ``block_fn`` hook and the
shared MLM head) whose blocks ``moe_every - 1``, ``2 moe_every - 1``, ...
(never block 0) replace their dense MLP with a routed expert MLP
(:class:`..models.gpt_moe.MoEMLP`, all experts on this device,
:func:`..parallel.moe.local_moe`).  The default router is expert choice
(Zhou et al. 2022), acausal and so an encoder's: every expert takes its
top-k tokens, the balance is exact and the aux loss is 0; ``top1`` and
``top2`` are there for ablations, with a live aux loss.  Pads (the
attention mask's zeros) take no expert slot.

Over an ``expert`` axis the routed MLPs run the all-to-all region of
``parallel.moe.make_moe_fn`` (:func:`bind_expert_parallel_bert`), each
token shard choosing its own top tokens as in JAX; :func:`bert_moe_layout`
is BERT's ``model``-axis layout after the expert rules.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..device import resolve_device
from ..parallel.moe import bind_expert_parallel_model, with_moe_layout
from .bert import (
    BertConfig,
    BertEncoder,
    SelfAttention,
    TransformerBlock,
    _mlm_metrics,
    add_mlm_head,
    bert_layout,
    mlm_head,
)
from .gpt_moe import MoEMLP, _expert_mlp
from .layers import FusedLayerNorm, dropout


@dataclasses.dataclass(frozen=True)
class BertMoEConfig(BertConfig):
    n_experts: int = 8
    capacity_factor: float = 1.25
    #: "expert_choice" (aux-free) or "top1"/"top2" (live aux loss) for
    #: ablations.
    router: str = "expert_choice"
    #: every k-th block carries the routed MLP (ST-MoE interleaving).
    moe_every: int = 2

    def is_moe_layer(self, i: int) -> bool:
        """Blocks k-1, 2k-1, ...; never block 0."""
        return i % self.moe_every == self.moe_every - 1


def bert_moe_base() -> BertMoEConfig:
    return BertMoEConfig()


def bert_moe_tiny() -> BertMoEConfig:
    """Test-size config (2 layers, 1 routed, 4 experts)."""
    return BertMoEConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                         num_heads=4, intermediate_size=512,
                         max_position=128, n_experts=4)


class MoETransformerBlock(nn.Module):
    """Post-LN encoder block with a routed-expert MLP; returns (x, aux).
    The routed MLP sees the attention LayerNorm's output in the compute
    dtype, and the tokens that the (B, 1, 1, S) attention mask marks as
    real; dropout sits on the routed output, the dense MLP's site."""

    def __init__(self, cfg: BertMoEConfig, device=None, group=None,
                 moe_fn=None):
        super().__init__()
        self.cfg = cfg
        e = cfg.hidden_size
        self.attention = SelfAttention(cfg, device=device)
        self.ln_attn = FusedLayerNorm(e, out_dtype=torch.float32,
                                      device=device)
        self.moe_mlp = MoEMLP(cfg, device=device, group=group, moe_fn=moe_fn)
        self.ln_mlp = FusedLayerNorm(e, out_dtype=torch.float32,
                                     device=device)

    def forward(self, x, mask, segment_ids, seeds=(None, None)):
        x = self.ln_attn(x + self.attention(x, mask, segment_ids, seeds[0]))
        token_mask = None if mask is None else mask[:, 0, 0, :]
        m, aux = self.moe_mlp(x.to(self.cfg.dtype), token_mask)
        return self.ln_mlp(x + dropout(m, self.cfg.dropout_rate,
                                       seeds[1])), aux


class BertMoEForMLM(nn.Module):
    """The MoE encoder and BERT's MLM head; ``forward`` takes
    :class:`..models.bert.BertForMLM`'s arguments and returns ``(logits,
    aux)``, which ``bert.mlm_eval`` and :func:`moe_mlm_loss` read
    (``moe_aux_loss`` in the metrics).  ``group``: the data-parallel
    group (or mesh) whose global batch the routers route; ``moe_fn``: the
    expert-parallel region of every routed MLP
    (:func:`bind_expert_parallel_bert`)."""

    def __init__(self, cfg: BertMoEConfig = BertMoEConfig(), *, device=None,
                 group=None, moe_fn=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.moe_fn = moe_fn

        def block_fn(i):
            if cfg.is_moe_layer(i):
                return MoETransformerBlock(cfg, device=device, group=group,
                                           moe_fn=moe_fn)
            return TransformerBlock(cfg, device=device)

        self.encoder = BertEncoder(cfg, device=device, block_fn=block_fn)
        add_mlm_head(self, cfg, device)

    @property
    def device(self) -> torch.device:
        return self.mlm_out.weight.device

    def forward(self, input_ids, *, attention_mask=None, segment_ids=None,
                position_ids=None, masked_positions=None,
                deterministic=True, generator=None):
        x, aux = self.encoder(input_ids, attention_mask, segment_ids,
                              position_ids, generator, deterministic)
        return mlm_head(self, x, masked_positions), aux


def moe_mlm_loss(model: BertMoEForMLM, *, max_predictions: int | None = None,
                 aux_weight: float = 1e-2, group=None):
    """``bert.mlm_loss`` plus ``aux_weight`` times the routers' aux loss
    (0 under expert choice; Switch's 1e-2 for the top-1/top-2
    ablations).  Over a data-parallel ``group`` every term is this rank's
    share."""

    def loss_fn(batch, generator=None):
        loss, metrics = _mlm_metrics(model, max_predictions, batch,
                                     generator, False, group)
        aux = metrics["moe_aux_loss"]
        metrics["moe_aux_loss"] = aux.detach()
        return loss + aux_weight * aux, metrics

    return loss_fn


def bert_moe_layout():
    """BERT's ``model``-axis rules after the expert-parallel ones (JAX
    ``bert_moe_layout``)."""
    return with_moe_layout(bert_layout())


def bind_expert_parallel_bert(cfg: BertMoEConfig, mesh, *, device=None,
                              group=None) -> BertMoEForMLM:
    """The all-to-all region over ``mesh``'s ``expert`` axis when it is
    larger than 1, the local experts otherwise: the contract of
    ``gpt_moe.bind_expert_parallel``."""
    return bind_expert_parallel_model(cfg, mesh, BertMoEForMLM, _expert_mlp,
                                      device=device, group=group)
