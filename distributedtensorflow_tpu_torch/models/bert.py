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
site drawn from the step's generator.

The MLM head is its own fp32 ``Dense(V)`` (``mlm_out``), not tied to the
embedding, whatever the JAX docstring says (``:180,184``).  The gathered
head (:func:`gathered_positions`) runs it at the first P masked positions
of each row, found by a stable sort where JAX takes ``lax.top_k`` of the
0/1 mask (lowest index first among ties).  Submodules carry the flax
tree's names, so a parameter's name is its flax path.  The presets pass
no token types, so the JAX init makes no ``type_embed`` table and
neither does the port; quantised matmuls (``quant``) are not ported and
raise.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.attention import dot_product_attention
from ..parallel.collectives import all_reduce, share_of_mean
from .layers import Dense, FusedLayerNorm, dense, dropout


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
    #: Quantised matmuls are not ported; only None / "none" is accepted.
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
    return table.weight[ids].to(dtype)


def _seed(generator):
    """One dropout seed from the step's generator."""
    return int(torch.randint(2**62, (), generator=generator))


class SelfAttention(nn.Module):
    """q, k, v and the output projection as biased (E, E) products; their
    flax kernels are (E, H, D) and (H, D, E) ``DenseGeneral`` kernels."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        e, h, d = cfg.hidden_size, cfg.num_heads, cfg.head_dim
        for name in ("query", "key", "value"):
            self.add_module(name, Dense(
                e, e, dtype=cfg.dtype, use_bias=True, kernel_shape=(e, h, d),
                bias_shape=(h, d), device=device))
        self.out = Dense(e, e, dtype=cfg.dtype, use_bias=True,
                         kernel_shape=(h, d, e), device=device)

    def forward(self, x, mask, segment_ids, seed):
        cfg = self.cfg
        b, s, _ = x.shape
        heads = (b, s, cfg.num_heads, cfg.head_dim)
        q, k, v = (getattr(self, n)(x).reshape(heads)
                   for n in ("query", "key", "value"))
        out = dot_product_attention(q, k, v, mask=mask,
                                    segment_ids=segment_ids)
        out = self.out(out.reshape(b, s, cfg.hidden_size))
        return dropout(out, cfg.dropout_rate, seed)


class TransformerBlock(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        e, f = cfg.hidden_size, cfg.intermediate_size
        # the picker raises for a quantised mode before anything is built
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
    """Embeddings, their LayerNorm and the blocks (``layer_{i}``)."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        e = cfg.hidden_size
        self.tok_embed = nn.Embedding(cfg.vocab_size, e, device=device)
        self.pos_embed = nn.Embedding(cfg.max_position, e, device=device)
        self.ln_embed = FusedLayerNorm(e, out_dtype=torch.float32,
                                       device=device)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", TransformerBlock(cfg, device=device))

    def forward(self, input_ids, attention_mask=None, segment_ids=None,
                position_ids=None, generator=None, deterministic=True):
        """fp32 hidden states (B, S, E).  ``segment_ids`` and
        ``position_ids`` (B, S) are a packed batch's: attention stays in a
        segment and positions restart per example."""
        cfg = self.cfg
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[-1],
                                        device=input_ids.device)
        x = (_embed(self.tok_embed, input_ids, cfg.dtype)
             + _embed(self.pos_embed, position_ids, cfg.dtype))
        train = not deterministic and cfg.dropout_rate > 0
        x = dropout(self.ln_embed(x), cfg.dropout_rate,
                    _seed(generator) if train else None)
        mask = None
        if attention_mask is not None:
            mask = attention_mask[:, None, None, :].bool()
        for i in range(cfg.num_layers):
            seeds = (_seed(generator), _seed(generator)) if train \
                else (None, None)
            x = getattr(self, f"layer_{i}")(x, mask, segment_ids, seeds)
        return x


class BertForMLM(nn.Module):
    """The encoder and the MLM head (``mlm_transform``, ``mlm_ln``,
    ``mlm_out``).  Parameters live on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``)."""

    def __init__(self, cfg: BertConfig = BertConfig(), *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        e = cfg.hidden_size
        self.encoder = BertEncoder(cfg, device=device)
        self.mlm_transform = Dense(e, e, dtype=cfg.dtype, use_bias=True,
                                   device=device)
        self.mlm_ln = FusedLayerNorm(e, out_dtype=torch.float32,
                                     device=device)
        self.mlm_out = Dense(e, cfg.vocab_size, dtype=torch.float32,
                             use_bias=True, device=device)

    @property
    def device(self) -> torch.device:
        return self.mlm_out.weight.device

    def forward(self, input_ids, *, attention_mask=None, segment_ids=None,
                position_ids=None, masked_positions=None,
                deterministic=True, generator=None):
        """fp32 logits (B, S, V), or (B, P, V) at ``masked_positions``
        (B, P): the head then runs on P positions instead of S."""
        x = self.encoder(input_ids, attention_mask, segment_ids,
                         position_ids, generator, deterministic)
        if masked_positions is not None:
            x = torch.gather(x, 1, masked_positions[..., None].expand(
                -1, -1, x.shape[-1]))
        x = F.gelu(self.mlm_transform(x), approximate="tanh")
        return self.mlm_out(self.mlm_ln(x))


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
    the share of rows that had more masked positions than it keeps.  Over
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


def mlm_eval(model: BertForMLM, *, max_predictions: int | None = None):
    """``metric_fn(batch) -> {"loss", "mlm_accuracy", ...}``,
    deterministic, without autograd (JAX ``mlm_eval``)."""

    def metric_fn(batch):
        with torch.no_grad():
            loss, metrics = _mlm_metrics(model, max_predictions, batch, None,
                                         True)
        return {"loss": loss, **metrics}

    return metric_fn
