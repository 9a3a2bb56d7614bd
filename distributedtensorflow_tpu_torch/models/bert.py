"""BERT masked-LM: the ``bert_mlm`` and ``bert_mlm_packed`` presets'
model and losses.

Twin of ``distributedtensorflow_tpu/models/bert.py`` (``:29-297``):
post-LN encoder blocks, bf16 compute with fp32 parameters, LayerNorms
that emit fp32 (the port's :class:`FusedLayerNorm`: the kernels K1f and,
under autograd, K1b on the card), tanh-approximated GELU, and attention
through ``ops.attention.dot_product_attention`` with a padding mask or
packed segment ids (the plain path below the flash gate's sequence
length, the flash kernels K2/K3f above it).  Dropout sits on the
embedding output, the attention output and the MLP output, one seed a
site drawn from the step's ``DropoutKey`` (``layers.draw_seed``).

The MLM head is its own fp32 ``Dense(V)`` (``mlm_out``), not tied to the
embedding, whatever the JAX docstring says (``:180,184``).  The gathered
head (:func:`gathered_positions`) runs it at the first P masked positions
of each row, found by a stable sort where JAX takes ``lax.top_k`` of the
0/1 mask (lowest index first among ties).  Submodules carry the flax
tree's names, so a parameter's name is its flax path.  The presets pass
no token types, so the JAX init makes no ``type_embed`` table and
neither does the port.  ``quant`` runs the attention and MLP products
quantised (``layers.QuantDense``); the embeddings, LayerNorms and the
head stay full width.  :func:`bert_layout` splits the blocks and the
embedding rows over a ``model`` axis.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.attention import dot_product_attention
from ..parallel.collectives import all_reduce, share_of_mean
from ..parallel.sharding import LayoutMap, P
from .layers import (
    FusedLayerNorm,
    bind_quant_seed,
    dense,
    draw_seed,
    dropout,
    embed_rows,
    number_quant_sites,
)
from .layers import Dense


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    dropout_rate: float = 0.1
    dtype: torch.dtype = torch.bfloat16
    #: Quantised attention and MLP matmuls (``ops.quant``), or None.
    quant: str | None = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def bert_base() -> BertConfig:
    return BertConfig()


def bert_tiny() -> BertConfig:
    """Test-size config (2 layers, 128 hidden)."""
    return BertConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                      num_heads=4, intermediate_size=512, max_position=128)


def _embed(table: nn.Embedding, ids, dtype):
    """flax ``nn.Embed(dtype=...)``: gather, then cast (the same values as
    casting the whole table)."""
    return embed_rows(table, ids).to(dtype)


class SelfAttention(nn.Module):
    """q, k, v and the output projection as biased (E, E) products; their
    flax kernels are (E, H, D) and (H, D, E) ``DenseGeneral`` kernels."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        e, h, d = cfg.hidden_size, cfg.num_heads, cfg.head_dim
        for name in ("query", "key", "value"):
            self.add_module(name, dense(
                e, e, dtype=cfg.dtype, quant=cfg.quant, use_bias=True,
                kernel_shape=(e, h, d), bias_shape=(h, d), device=device))
        self.out = dense(e, e, dtype=cfg.dtype, quant=cfg.quant,
                         use_bias=True, kernel_shape=(h, d, e), device=device)

    def forward(self, x, mask, segment_ids, seed):
        cfg = self.cfg
        b, s, _ = x.shape
        # -1 heads: this rank's over a model axis
        heads = (b, s, -1, cfg.head_dim)
        q, k, v = (getattr(self, n)(x).reshape(heads)
                   for n in ("query", "key", "value"))
        out = dot_product_attention(q, k, v, mask=mask,
                                    segment_ids=segment_ids)
        out = self.out(out.reshape(b, s, -1))
        return dropout(out, cfg.dropout_rate, seed)


class TransformerBlock(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        e, f = cfg.hidden_size, cfg.intermediate_size
        self.mlp_in = dense(e, f, dtype=cfg.dtype, quant=cfg.quant,
                            use_bias=True, device=device)
        self.mlp_out = dense(f, e, dtype=cfg.dtype, quant=cfg.quant,
                             use_bias=True, device=device)
        self.attention = SelfAttention(cfg, device=device)
        self.ln_attn = FusedLayerNorm(e, out_dtype=torch.float32,
                                      device=device)
        self.ln_mlp = FusedLayerNorm(e, out_dtype=torch.float32,
                                     device=device)

    def forward(self, x, mask, segment_ids, seeds=(None, None)):
        x = self.ln_attn(x + self.attention(x, mask, segment_ids, seeds[0]))
        h = self.mlp_out(F.gelu(self.mlp_in(x), approximate="tanh"))
        return self.ln_mlp(x + dropout(h, self.cfg.dropout_rate, seeds[1]))


class BertEncoder(nn.Module):
    """Embeddings, their LayerNorm and the blocks (``layer_{i}``).

    ``block_fn(i)`` (JAX ``:119-131``) builds block ``i`` in place of a
    :class:`TransformerBlock`, so a variant swaps blocks without its own
    embedding stack (the MoE encoder, ``models/bert_moe.py``).  A block
    returns ``x`` or ``(x, aux)``; the aux losses are summed."""

    def __init__(self, cfg: BertConfig, device=None, block_fn=None):
        super().__init__()
        self.cfg = cfg
        e = cfg.hidden_size
        self.tok_embed = nn.Embedding(cfg.vocab_size, e, device=device)
        self.pos_embed = nn.Embedding(cfg.max_position, e, device=device)
        self.ln_embed = FusedLayerNorm(e, out_dtype=torch.float32,
                                       device=device)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", TransformerBlock(cfg, device=device)
                            if block_fn is None else block_fn(i))
        number_quant_sites(self)

    def forward(self, input_ids, attention_mask=None, segment_ids=None,
                position_ids=None, generator=None, deterministic=True):
        """``(x, aux)``: fp32 hidden states (B, S, E) and the blocks' aux
        losses summed (0 for dense blocks).  ``segment_ids`` and
        ``position_ids`` (B, S) are a packed batch's: attention stays in a
        segment and positions restart per example."""
        cfg = self.cfg
        bind_quant_seed(self, None if deterministic else generator)
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[-1],
                                        device=input_ids.device)
        x = (_embed(self.tok_embed, input_ids, cfg.dtype)
             + _embed(self.pos_embed, position_ids, cfg.dtype))
        train = not deterministic and cfg.dropout_rate > 0
        x = dropout(self.ln_embed(x), cfg.dropout_rate,
                    draw_seed(generator) if train else None)
        mask = None
        if attention_mask is not None:
            mask = attention_mask[:, None, None, :].bool()
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(cfg.num_layers):
            seeds = (draw_seed(generator), draw_seed(generator)) if train \
                else (None, None)
            x = getattr(self, f"layer_{i}")(x, mask, segment_ids, seeds)
            if isinstance(x, tuple):
                x, aux = x
                aux_total = aux_total + aux
        return x, aux_total


def add_mlm_head(module: nn.Module, cfg: BertConfig, device=None) -> None:
    """The MLM head's submodules (``mlm_transform``, ``mlm_ln``,
    ``mlm_out``) on ``module``: the one definition that
    :class:`BertForMLM` and the MoE encoder share (JAX ``mlm_head``,
    ``:170``)."""
    e = cfg.hidden_size
    module.mlm_transform = Dense(e, e, dtype=cfg.dtype, use_bias=True,
                                 device=device)
    module.mlm_ln = FusedLayerNorm(e, out_dtype=torch.float32, device=device)
    module.mlm_out = Dense(e, cfg.vocab_size, dtype=torch.float32,
                           use_bias=True, device=device)


def mlm_head(module: nn.Module, x, masked_positions=None):
    """fp32 logits of ``module``'s MLM head (see :func:`add_mlm_head`) at
    every position of ``x`` (B, S, E), or (B, P, V) at
    ``masked_positions`` (B, P)."""
    if masked_positions is not None:
        x = torch.gather(x, 1, masked_positions[..., None].expand(
            -1, -1, x.shape[-1]))
    x = F.gelu(module.mlm_transform(x), approximate="tanh")
    return module.mlm_out(module.mlm_ln(x))


class BertForMLM(nn.Module):
    """The encoder and the MLM head (``mlm_transform``, ``mlm_ln``,
    ``mlm_out``).  Parameters live on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``)."""

    def __init__(self, cfg: BertConfig = BertConfig(), *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.encoder = BertEncoder(cfg, device=device)
        add_mlm_head(self, cfg, device)

    @property
    def device(self) -> torch.device:
        return self.mlm_out.weight.device

    def forward(self, input_ids, *, attention_mask=None, segment_ids=None,
                position_ids=None, masked_positions=None,
                deterministic=True, generator=None):
        """fp32 logits (B, S, V), or (B, P, V) at ``masked_positions``
        (B, P): the head then runs on P positions instead of S."""
        x, _ = self.encoder(input_ids, attention_mask, segment_ids,
                            position_ids, generator, deterministic)
        return mlm_head(self, x, masked_positions)


def bert_layout() -> LayoutMap:
    """Megatron-style ``model``-axis rules (JAX ``bert_layout``,
    ``models/bert.py:300-316``): q, k, v and mlp_in column-parallel, the
    attention output and mlp_out row-parallel, the embeddings split by
    rows."""
    return LayoutMap([
        (r"(query|key|value)/kernel", P(None, "model", None)),
        (r"attention/out/kernel", P("model", None, None)),
        (r"mlp_in/kernel", P(None, "model")),
        (r"mlp_out/kernel", P("model", None)),
        (r"(tok|pos|type)_embed/embedding", P("model", None)),
        (r"(query|key|value)/bias", P("model", None)),
    ])


def max_predictions_for(seq_len: int) -> int:
    """Gathered-head size for a sequence length: 20% of positions (the
    mask rate is 15%; a row with more masked positions drops the
    excess)."""
    return seq_len // 5 + 1


def gathered_positions(valid, p: int):
    """``(weights, positions)`` (B, P): the first ``p`` positions of each
    row where ``valid`` (B, S) is True, in index order, then its first
    invalid ones (weight 0) where a row has fewer; ``lax.top_k`` of the
    0/1 mask, whose ties go to the lowest index."""
    w, pos = torch.sort(valid.to(torch.int32), dim=1, descending=True,
                        stable=True)
    return w[:, :p], pos[:, :p]


def _mlm_metrics(model: BertForMLM, max_predictions, batch, generator,
                 deterministic, group=None):
    """The loss and metrics shared by :func:`mlm_loss` and
    :func:`mlm_eval` (JAX ``_mlm_metrics``, ``:208-270``): cross-entropy
    over the masked positions (``labels`` >= 0; -100 elsewhere), weighted
    and divided by their count (at least 1), and the masked accuracy;
    with ``max_predictions`` the gathered head and ``mlm_clipped_rows``,
    the share of rows that had more masked positions than it keeps; a
    model that returns ``(logits, aux)`` (the MoE encoder) adds
    ``moe_aux_loss``.  Over
    a data-parallel ``group`` the count divides by every rank's masked
    positions (JAX's weight sum over the global microbatch), so the loss
    and metrics are this rank's shares of the global values."""
    labels = batch["labels"]
    valid = labels >= 0
    kw = dict(attention_mask=batch.get("attention_mask"),
              segment_ids=batch.get("segment_ids"),
              position_ids=batch.get("position_ids"),
              deterministic=deterministic, generator=generator)
    extra = {}
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    if max_predictions:
        p = min(max_predictions, labels.shape[1])
        w, pos = gathered_positions(valid, p)
        extra["mlm_clipped_rows"] = (valid.sum(1) > p).float().mean()
        if group is not None:
            extra["mlm_clipped_rows"] *= share_of_mean(labels.shape[0],
                                                       group)
        logits = model(batch["input_ids"], masked_positions=pos, **kw)
        safe = torch.gather(safe, 1, pos)
        w = w.float()
    else:
        logits = model(batch["input_ids"], **kw)
        w = valid.float()
    if isinstance(logits, tuple):  # the MoE encoder: (logits, router aux)
        logits, extra["moe_aux_loss"] = logits
    logits = logits.float()
    per_tok = F.cross_entropy(logits.flatten(0, 1), safe.flatten(),
                              reduction="none").view(safe.shape)
    denom = w.sum() if group is None else all_reduce(w.sum().detach(), group)
    denom = denom.clamp_min(1.0)
    loss = (per_tok * w).sum() / denom
    acc = ((logits.argmax(-1) == safe) * w).sum() / denom
    return loss, {"mlm_accuracy": acc.detach(), **extra}


def mlm_loss(model: BertForMLM, *, max_predictions: int | None = None,
             group=None):
    """``loss_fn(batch, generator=None) -> (loss, metrics)`` for masked-LM
    batches ``{input_ids, labels}`` plus ``attention_mask`` or the packed
    ``segment_ids``/``position_ids``; dropout on (JAX ``mlm_loss``).
    ``group``: a data-parallel group (or mesh); the loss and metrics are
    then this rank's shares of the global microbatch's."""

    def loss_fn(batch, generator=None):
        return _mlm_metrics(model, max_predictions, batch, generator, False,
                            group)

    return loss_fn


def mlm_eval(model: BertForMLM, *, max_predictions: int | None = None,
             group=None):
    """``metric_fn(batch) -> {"loss", "mlm_accuracy", ...}``,
    deterministic, without autograd (JAX ``mlm_eval``); over a
    data-parallel ``group`` this rank's shares of the global eval
    batch's."""

    def metric_fn(batch):
        with torch.no_grad():
            loss, metrics = _mlm_metrics(model, max_predictions, batch, None,
                                         True, group)
        return {"loss": loss, **metrics}

    return metric_fn
