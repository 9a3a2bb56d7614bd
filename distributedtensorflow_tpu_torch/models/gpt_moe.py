"""GPT-MoE: the decoder LM with routed-expert MLPs.

Twin of ``distributedtensorflow_tpu/models/gpt_moe.py``: every
``moe_every_k``-th block replaces its dense MLP with a routed expert MLP
(top-2 GShard routing by default, :func:`..parallel.moe.local_moe`, the
path JAX takes when the mesh has no ``expert`` axis), and the routers'
load-balancing loss is folded into the LM loss.  The other blocks, the
attention, the LayerNorms and the rotary tables are ``models/gpt.py``'s.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops.xent import tied_head_logits
from ..parallel.collectives import share_of_mean
from ..parallel.moe import local_moe
from .gpt import (
    CausalSelfAttention,
    GPTBlock,
    GPTConfig,
    _pick_xent,
    _target_count,
    rope_tables,
)
from .layers import FusedLayerNorm


@dataclasses.dataclass(frozen=True)
class GPTMoEConfig(GPTConfig):
    n_experts: int = 8
    moe_every_k: int = 2  # every k-th block is MoE (1 = all blocks)
    capacity_factor: float = 1.25
    #: "top2" (GShard) or "top1" (Switch).  "expert_choice" is refused:
    #: its per-expert top-k reads future tokens' router scores.
    router: str = "top2"
    aux_loss_weight: float = 1e-2

    def is_moe_layer(self, i: int) -> bool:
        """Blocks k-1, 2k-1, ... (the last of each group of k) are MoE."""
        return (i + 1) % self.moe_every_k == 0


def gpt_moe_small() -> GPTMoEConfig:
    """GPT-2-small with eight experts on every second block."""
    return GPTMoEConfig()


def gpt_moe_tiny() -> GPTMoEConfig:
    """Test-size: 2 blocks (1 dense + 1 MoE), 4 experts."""
    return GPTMoEConfig(
        vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
        intermediate_size=256, max_seq=256, remat=False,
        n_experts=4, moe_every_k=2,
    )


def _expert_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Every expert's FFN at once: x (E, N, d) -> (E, N, d), the weights
    cast to x's dtype per call, tanh GELU, no bias."""
    h = F.gelu(torch.bmm(x, params["w_in"].to(x.dtype)), approximate="tanh")
    return torch.bmm(h, params["w_out"].to(x.dtype))


class MoEMLP(nn.Module):
    """Routed expert MLP over all experts on this device.  Parameters in
    fp32 with the flax shapes: ``router`` (d, E), ``experts_in`` (E, d,
    F), ``experts_out`` (E, F, d).  With a data-parallel ``group`` it
    routes the global batch (:func:`..parallel.moe.local_moe`)."""

    def __init__(self, cfg: GPTMoEConfig, device=None, group=None):
        super().__init__()
        self.cfg = cfg
        self.group = group
        e, f, n = cfg.hidden_size, cfg.intermediate_size, cfg.n_experts
        kw = dict(dtype=torch.float32, device=device)
        self.router = nn.Parameter(torch.zeros(e, n, **kw))
        self.experts_in = nn.Parameter(torch.zeros(n, e, f, **kw))
        self.experts_out = nn.Parameter(torch.zeros(n, f, e, **kw))

    def forward(self, x, token_mask=None):
        """``(out (B, S, d), aux)``; ``token_mask`` (B, S), 1 = real
        token (pads take no expert slot), None = all real."""
        cfg = self.cfg
        b, s, d = x.shape
        out, aux = local_moe(
            x.reshape(b * s, d), self.router,
            {"w_in": self.experts_in, "w_out": self.experts_out},
            _expert_mlp, capacity_factor=cfg.capacity_factor,
            router=cfg.router,
            token_mask=None if token_mask is None
            else token_mask.reshape(b * s), group=self.group)
        return out.reshape(b, s, d), aux


class MoEGPTBlock(nn.Module):
    """Pre-LN decoder block with a routed-expert MLP; returns (x, aux)."""

    def __init__(self, cfg: GPTMoEConfig, device=None, group=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = FusedLayerNorm(cfg.hidden_size, device=device)
        self.attn = CausalSelfAttention(cfg, device=device)
        self.ln2 = FusedLayerNorm(cfg.hidden_size, device=device)
        self.moe_mlp = MoEMLP(cfg, device=device, group=group)

    def forward(self, x, positions, rope_tabs):
        h = self.ln1(x)
        if self.cfg.remat_attn and torch.is_grad_enabled():
            a = checkpoint(self.attn, h, positions, rope_tabs, None,
                           use_reentrant=False)
        else:
            a = self.attn(h, positions, rope_tabs, None)
        x = x + a
        m, aux = self.moe_mlp(self.ln2(x))
        return x + m, aux


class GPTMoELM(nn.Module):
    """Decoder LM with MoE MLPs every ``moe_every_k`` blocks.

    ``forward(input_ids)`` returns ``(logits fp32, aux)``, or ``(hidden
    fp32, aux)`` with ``return_hidden``: aux is the routers' load-balancing
    loss summed over the MoE blocks.  Block remat covers both kinds of
    block; dropout (dense blocks only, as in JAX) draws one seed per
    block from ``generator``.  Parameters live on ``device`` (``cuda``
    unless the caller passes ``"cpu"``).  ``group``: the data-parallel
    group (or mesh) whose global batch the routers route; aux is then
    this rank's share."""

    def __init__(self, cfg: GPTMoEConfig, *, device=None, group=None):
        super().__init__()
        if cfg.router == "expert_choice":
            raise ValueError(
                "expert_choice routing is non-causal (each expert's top-k "
                "reads the whole sequence's router scores, future tokens "
                "included): invalid for this autoregressive LM; pick "
                "'top1' or 'top2'")
        device = resolve_device(device)
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                device=device, dtype=torch.float32)
        self.h = nn.ModuleList(
            [MoEGPTBlock(cfg, device=device, group=group)
             if cfg.is_moe_layer(i)
             else GPTBlock(cfg, device=device)
             for i in range(cfg.num_layers)])
        self.ln_f = FusedLayerNorm(cfg.hidden_size, out_dtype=torch.float32,
                                   device=device)

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    def forward(self, input_ids, *, deterministic: bool = True,
                generator=None, return_hidden: bool = False):
        cfg = self.cfg
        x = self.wte.weight[input_ids].to(cfg.dtype)
        positions = torch.arange(input_ids.shape[1],
                                 device=x.device).expand(input_ids.shape)
        tabs = rope_tables(positions, cfg.head_dim, cfg.rope_theta, cfg.dtype)
        remat = cfg.remat and torch.is_grad_enabled()
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, block in enumerate(self.h):
            moe = cfg.is_moe_layer(i)
            args = (x, positions, tabs)
            if not moe:
                seed = None
                if not deterministic and cfg.dropout_rate:
                    seed = int(torch.randint(2**62, (), generator=generator))
                args += (None, seed)
            out = checkpoint(block, *args, use_reentrant=False) if remat \
                else block(*args)
            if moe:
                x, aux = out
                aux_total = aux_total + aux
            else:
                x = out
        x = self.ln_f(x)
        if return_hidden:
            return x, aux_total
        return tied_head_logits(x, self.wte.weight, cfg.dtype), aux_total


def _lm_terms(model: GPTMoELM, xent, batch, group=None, **kw):
    ids = batch["input_ids"]
    hidden, aux = model(ids, return_hidden=True, **kw)
    lm = xent(hidden[:, :-1], model.wte.weight, ids[:, 1:], None,
              compute_dtype=model.cfg.dtype)
    if group is not None:
        lm = lm * share_of_mean(
            _target_count(ids[:, 1:], None, model.cfg.vocab_size), group)
    return lm, aux


def moe_lm_loss(model: GPTMoELM, group=None):
    """Next-token cross-entropy plus the weighted router aux loss, through
    the head :func:`..models.gpt._pick_xent` picks for the model's device:
    ``loss_fn(batch, generator=None) -> (lm + aux_loss_weight * aux,
    {"perplexity": exp(lm), "aux_loss": aux})``.  Over a data-parallel
    ``group`` (the model built with the same group, so that its routers
    route the global batch) every term is this rank's share and the
    perplexity is reported as ``log_perplexity``, as :func:`..gpt.lm_loss`
    does."""
    xent = _pick_xent(model.cfg, model.device)
    aux_w = model.cfg.aux_loss_weight

    def loss_fn(batch, generator=None):
        lm, aux = _lm_terms(model, xent, batch, group, deterministic=False,
                            generator=generator)
        if group is not None:
            return lm + aux_w * aux, {"log_perplexity": lm.detach(),
                                      "aux_loss": aux.detach()}
        return lm + aux_w * aux, {"perplexity": torch.exp(lm.detach()),
                                  "aux_loss": aux.detach()}

    return loss_fn


def moe_lm_eval(model: GPTMoELM):
    """Eval metric_fn: deterministic, without autograd; the router aux
    loss is reported but not folded into the eval loss."""
    xent = _pick_xent(model.cfg, model.device)

    def metric_fn(batch):
        with torch.no_grad():
            lm, aux = _lm_terms(model, xent, batch)
        return {"loss": lm, "perplexity": torch.exp(lm), "aux_loss": aux}

    return metric_fn
