"""Encoder-decoder seq2seq LM: the ``t5_seq2seq`` preset's model, its
teacher-forced loss and eval, and KV-cached greedy or sampled decoding.

Twin of ``distributedtensorflow_tpu/models/seq2seq.py``: ``Seq2SeqConfig``
(``:55-87``), ``seq2seq_small``/``seq2seq_tiny`` (``:89-99``),
``_Attention`` (``:102-179``), ``_MLP``, ``EncoderBlock``,
``DecoderBlock``, ``Seq2SeqLM`` with ``encode``/``decode`` (``:245-335``),
``shift_right``, ``seq2seq_loss``, ``seq2seq_eval`` (``:345-394``) and
``seq2seq_generate`` (``:397-484``).

Pre-RMSNorm blocks (:class:`~.layers.RMSNorm`: fp32, cast to the compute
dtype before attention and the MLP) over an fp32 residual stream that
starts from the bf16-rounded rows of the tied ``shared`` table (flax's
``nn.Embed(dtype=bf16)`` casts the table before the gather).  q/k/v are
``DenseGeneral`` products without bias, kernels (E, H, D) or (E, Hkv, D)
under GQA, ``out`` (H, D, E).  Rotary embeddings per stream: decoder
positions rotate q, encoder positions rotate the cross-attention's k;
the tables are computed once a stream and shared by the layers.  The
encoder and cross-attention masks are ``pad[:, None, None, :]`` (padded
query rows are computed and attend over the real keys).  Attention goes
through ``ops.attention.dot_product_attention``, which takes the plain
path below the flash gate's sequence length, as JAX's ``"auto"`` does at
the preset's 256.  The head is the tied chunked head
(``ops.xent.chunked_softmax_xent``, XLA in JAX; no Pallas kernel), the
eval's accuracy the tied chunked argmax.

Decode mode: a cache dict the caller owns (:meth:`Seq2SeqLM.init_cache`),
``cache["dec_{i}"]["attention"]`` the GPT layout
(``cached_key``/``cached_value`` (B, Hkv, max_seq, D) and
``cache_index``) and ``cache["dec_{i}"]["cross_attention"]`` empty until
the first (priming) step projects the real encoder output to K/V and
banks it there; later steps read it.  A one-token self-attention step
runs ``ops.attention.cached_decode_attention`` (the kernel K5 on the
card).  Submodules carry the flax tree's names, so a parameter's name is
its flax path.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.attention import cached_decode_attention, dot_product_attention
from ..ops.fused_xent import vocab_parallel_xent
from ..ops.xent import (
    chunked_argmax,
    chunked_softmax_xent,
    tied_head_logits,
    vocab_parallel_argmax,
)
from ..parallel.collectives import share_of_mean
from ..parallel.sharding import LayoutMap, P, shard_bounds
from .generate import _sample
from .gpt import _target_count, rope, rope_tables
from .layers import Dense, RMSNorm, TensorParallel, draw_seed, dropout, \
    embed_rows


@dataclasses.dataclass(frozen=True)
class Seq2SeqConfig:
    vocab_size: int = 32128
    hidden_size: int = 512
    num_heads: int = 8
    enc_layers: int = 6
    dec_layers: int = 6
    intermediate_size: int = 2048
    max_seq: int = 512
    dropout_rate: float = 0.0
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    #: Grouped-query attention: K/V heads of every attention, self and
    #: cross (None = num_heads).
    num_kv_heads: int | None = None
    #: id that starts every decoder input (the teacher-forcing shift-in)
    bos_id: int = 0
    #: padding id: out of the loss and of the encoder's keys
    pad_id: int = 1

    def __post_init__(self):
        kv = self.num_kv_heads
        if kv is not None and (kv <= 0 or self.num_heads % kv):
            raise ValueError(
                f"num_kv_heads={kv} must divide num_heads={self.num_heads}")

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def seq2seq_small() -> Seq2SeqConfig:
    """T5-small scale (~60M parameters with the 32k vocab)."""
    return Seq2SeqConfig()


def seq2seq_tiny() -> Seq2SeqConfig:
    """Test-size config (2+2 layers, 128 hidden)."""
    return Seq2SeqConfig(vocab_size=512, hidden_size=128, num_heads=4,
                         enc_layers=2, dec_layers=2, intermediate_size=256,
                         max_seq=128)


class _Attention(nn.Module):
    """Self-attention (``kv=None``) or cross-attention over ``kv``, q
    rotated by ``q_tabs`` and k by ``kv_tabs``.  With a ``cache``: causal
    self-attention runs one cached step, cross-attention reads (or, on
    the priming step, computes and banks) the projected encoder K/V."""

    def __init__(self, cfg: Seq2SeqConfig, *, causal: bool = False,
                 device=None):
        super().__init__()
        self.cfg, self.causal = cfg, causal
        e, h, hkv, d = (cfg.hidden_size, cfg.num_heads, cfg.kv_heads,
                        cfg.head_dim)
        self.query = Dense(e, h * d, dtype=cfg.dtype, kernel_shape=(e, h, d),
                           device=device)
        for name in ("key", "value"):
            self.add_module(name, Dense(e, hkv * d, dtype=cfg.dtype,
                                        kernel_shape=(e, hkv, d),
                                        device=device))
        self.out = Dense(h * d, e, dtype=cfg.dtype, kernel_shape=(h, d, e),
                         device=device)
        #: the K/V heads this rank's query heads read (all of them whole)
        self.kv_heads = (0, hkv)

    def tp_bind(self, rank: int, n: int, group) -> None:
        """This rank's query heads over a ``model`` group; K/V kept whole
        by the layout (GQA with fewer K/V heads than ranks,
        ``seq2seq_layout``) run on every rank and each takes the K/V heads
        its query heads read, their gradients summed over the ranks."""
        if self.key.tp is not None:
            return
        cfg = self.cfg
        group_size = cfg.num_heads // cfg.kv_heads
        lo, hi = shard_bounds(cfg.num_heads, rank, n)
        self.kv_heads = (lo // group_size, (hi - 1) // group_size + 1)
        for m in (self.key, self.value):
            m.tp = TensorParallel("rep", group)

    def forward(self, x, kv, *, q_tabs, kv_tabs, mask, seed=None,
                cache=None):
        cfg = self.cfg
        b, s, _ = x.shape
        d = cfg.head_dim
        q = rope(self.query(x).reshape(b, s, -1, d), None, cfg.rope_theta,
                 q_tabs)
        cross = cache is not None and not self.causal
        if cross and "cross_key" in cache:
            k, v = cache["cross_key"], cache["cross_value"]
        else:
            src = x if kv is None else kv
            sk = src.shape[1]
            lo, hi = self.kv_heads
            k = rope(self.key(src).reshape(b, sk, -1, d)[:, :, lo:hi], None,
                     cfg.rope_theta, kv_tabs)
            v = self.value(src).reshape(b, sk, -1, d)[:, :, lo:hi]
            if cross:
                cache["cross_key"], cache["cross_value"] = k, v
        if cache is not None and self.causal:
            out, cache["cached_key"], cache["cached_value"], \
                cache["cache_index"] = cached_decode_attention(
                    q, k, v, cache["cached_key"], cache["cached_value"],
                    cache["cache_index"])
        else:
            out = dot_product_attention(q, k, v, mask=mask,
                                        causal=self.causal)
        return dropout(self.out(out.reshape(b, s, -1)), cfg.dropout_rate,
                       seed)


class _MLP(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig, device=None):
        super().__init__()
        self.cfg = cfg
        e, f = cfg.hidden_size, cfg.intermediate_size
        self.mlp_in = Dense(e, f, dtype=cfg.dtype, device=device)
        self.mlp_out = Dense(f, e, dtype=cfg.dtype, device=device)

    def forward(self, x, seed=None):
        h = self.mlp_out(F.gelu(self.mlp_in(x), approximate="tanh"))
        return dropout(h, self.cfg.dropout_rate, seed)


class EncoderBlock(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.attention = _Attention(cfg, device=device)
        self.mlp = _MLP(cfg, device=device)
        self.ln_attn = RMSNorm(cfg.hidden_size, device=device)
        self.ln_mlp = RMSNorm(cfg.hidden_size, device=device)

    def forward(self, x, *, tabs, mask, seeds=(None, None)):
        dt = self.cfg.dtype
        x = x + self.attention(self.ln_attn(x).to(dt), None, q_tabs=tabs,
                               kv_tabs=tabs, mask=mask, seed=seeds[0])
        return x + self.mlp(self.ln_mlp(x).to(dt), seeds[1])


class DecoderBlock(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.attention = _Attention(cfg, causal=True, device=device)
        self.cross_attention = _Attention(cfg, device=device)
        self.mlp = _MLP(cfg, device=device)
        for name in ("ln_attn", "ln_cross", "ln_mlp"):
            self.add_module(name, RMSNorm(cfg.hidden_size, device=device))

    def forward(self, x, enc_out, *, tabs, enc_tabs, cross_mask,
                seeds=(None, None, None), cache=None):
        dt = self.cfg.dtype
        x = x + self.attention(
            self.ln_attn(x).to(dt), None, q_tabs=tabs, kv_tabs=tabs,
            mask=None, seed=seeds[0],
            cache=None if cache is None else cache["attention"])
        x = x + self.cross_attention(
            self.ln_cross(x).to(dt), enc_out, q_tabs=tabs, kv_tabs=enc_tabs,
            mask=cross_mask, seed=seeds[1],
            cache=None if cache is None else cache["cross_attention"])
        return x + self.mlp(self.ln_mlp(x).to(dt), seeds[2])


class Seq2SeqLM(nn.Module):
    """Tied-embedding encoder-decoder: ``forward(encoder_ids,
    decoder_ids)`` -> the decoder's final fp32 hidden states (B, S, E)
    (the losses apply the tied chunked head).  ``deterministic=False``
    with a dropout rate draws one seed a dropout site from ``generator``
    (the step's ``DropoutKey``).  Parameters live on ``device`` (``cuda``
    unless the caller passes ``"cpu"``)."""

    def __init__(self, cfg: Seq2SeqConfig = Seq2SeqConfig(), *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        e = cfg.hidden_size
        self.shared = nn.Embedding(cfg.vocab_size, e, device=device,
                                   dtype=torch.float32)
        for i in range(cfg.enc_layers):
            self.add_module(f"enc_{i}", EncoderBlock(cfg, device=device))
        for i in range(cfg.dec_layers):
            self.add_module(f"dec_{i}", DecoderBlock(cfg, device=device))
        self.enc_norm = RMSNorm(e, device=device)
        self.dec_norm = RMSNorm(e, device=device)

    @property
    def device(self) -> torch.device:
        return self.shared.weight.device

    def init_cache(self, batch: int) -> dict:
        """A zeroed decode cache for ``batch`` rows of ``cfg.max_seq``
        positions; the cross-attention K/V come with the priming step."""
        cfg = self.cfg
        shape = (batch, cfg.kv_heads, cfg.max_seq, cfg.head_dim)

        def zeros():
            return torch.zeros(shape, dtype=cfg.dtype, device=self.device)

        return {f"dec_{i}": {"attention": {"cached_key": zeros(),
                                           "cached_value": zeros(),
                                           "cache_index": 0},
                             "cross_attention": {}}
                for i in range(cfg.dec_layers)}

    def _check_len(self, ids, stream: str):
        if ids.shape[-1] > self.cfg.max_seq:
            raise ValueError(
                f"{stream} length {ids.shape[-1]} exceeds "
                f"cfg.max_seq={self.cfg.max_seq}; raise max_seq (RoPE has "
                "no table to outgrow, but lengths beyond the trained "
                "envelope degrade)")

    def _embed(self, ids):
        """flax ``nn.Embed(dtype=...)`` then ``.astype(float32)``: the rows
        rounded to the compute dtype, widened back."""
        return embed_rows(self.shared, ids).to(self.cfg.dtype).float()

    def _seeds(self, n, deterministic, generator):
        if deterministic or not self.cfg.dropout_rate:
            return (None,) * n
        return tuple(draw_seed(generator) for _ in range(n))

    def _tables(self, positions):
        cfg = self.cfg
        return rope_tables(positions, cfg.head_dim, cfg.rope_theta, cfg.dtype)

    def encode(self, encoder_ids, deterministic: bool = True,
               generator=None):
        """``(enc_out fp32 (B, S, E), pad (B, S) True = a real token,
        positions (B, S))``."""
        self._check_len(encoder_ids, "encoder")
        positions = torch.arange(encoder_ids.shape[-1],
                                 device=encoder_ids.device).expand(
                                     encoder_ids.shape)
        pad = encoder_ids != self.cfg.pad_id
        mask = pad[:, None, None, :]
        x = self._embed(encoder_ids)
        tabs = self._tables(positions)
        for i in range(self.cfg.enc_layers):
            x = getattr(self, f"enc_{i}")(
                x, tabs=tabs, mask=mask,
                seeds=self._seeds(2, deterministic, generator))
        return self.enc_norm(x), pad, positions

    def decode(self, decoder_ids, enc_out, enc_pad, enc_positions,
               deterministic: bool = True, positions=None, cache=None,
               generator=None):
        """The decoder's final fp32 hidden states; with a ``cache``
        (:meth:`init_cache`) the tokens are one decode step at
        ``positions``."""
        cfg = self.cfg
        self._check_len(decoder_ids, "decoder")
        if positions is None:
            positions = torch.arange(decoder_ids.shape[-1],
                                     device=decoder_ids.device).expand(
                                         decoder_ids.shape)
        cross_mask = enc_pad[:, None, None, :]
        x = self._embed(decoder_ids)
        tabs, enc_tabs = self._tables(positions), self._tables(enc_positions)
        enc_in = enc_out.to(cfg.dtype)
        for i in range(cfg.dec_layers):
            x = getattr(self, f"dec_{i}")(
                x, enc_in, tabs=tabs, enc_tabs=enc_tabs,
                cross_mask=cross_mask,
                seeds=self._seeds(3, deterministic, generator),
                cache=None if cache is None else cache[f"dec_{i}"])
        return self.dec_norm(x)

    def forward(self, encoder_ids, decoder_ids, deterministic: bool = True,
                generator=None):
        enc_out, enc_pad, enc_positions = self.encode(
            encoder_ids, deterministic, generator)
        return self.decode(decoder_ids, enc_out, enc_pad, enc_positions,
                           deterministic, generator=generator)


def seq2seq_layout(cfg: Seq2SeqConfig | None = None) -> LayoutMap:
    """Megatron ``model``-axis rules (JAX ``seq2seq_layout``,
    ``models/seq2seq.py:487-509``): the self-, cross- and MLP kernels of
    both stacks split as BERT's, the shared table by vocab rows; with GQA
    the key and value kernels stay whole (replicated)."""
    rules = [
        (r"(attention|cross_attention)/out/kernel", P("model", None, None)),
        (r"mlp_in/kernel", P(None, "model")),
        (r"mlp_out/kernel", P("model", None)),
        (r"shared/embedding", P("model", None)),
    ]
    if cfg is not None and cfg.kv_heads != cfg.num_heads:
        rules.insert(0, (r"query/kernel", P(None, "model", None)))
    else:
        rules.insert(0, (r"(query|key|value)/kernel", P(None, "model", None)))
    return LayoutMap(rules)


def shift_right(targets, bos_id: int):
    """Teacher-forcing decoder input: [BOS, t0, t1, ...] (drops the last)."""
    return torch.cat([torch.full_like(targets[:, :1], bos_id),
                      targets[:, :-1]], dim=1)


def _teacher_forced(model: Seq2SeqLM, batch, deterministic, generator):
    """``(hidden, targets, mask, loss)``: the decoder's states on the
    shifted targets, the non-pad mask and the mean NLL of the tied
    chunked head over it (targets outside [0, V) weigh 0)."""
    cfg = model.cfg
    targets = batch["targets"]
    hidden = model(batch["encoder_ids"], shift_right(targets, cfg.bos_id),
                   deterministic=deterministic, generator=generator)
    mask = (targets != cfg.pad_id).float()
    shard = getattr(model.shared, "tp", None)
    if shard is not None:  # split by vocab rows: plain twins, token tiles
        loss = vocab_parallel_xent(hidden, model.shared.weight, targets,
                                   mask, shard=shard, compute_dtype=cfg.dtype,
                                   kernels=False)
    else:
        loss = chunked_softmax_xent(hidden, model.shared.weight, targets,
                                    mask, compute_dtype=cfg.dtype)
    return hidden, targets, mask, loss


def _loss_share(model, loss, targets, mask, group):
    """This rank's share of the global mean (``lm_loss``'s rule)."""
    return loss * share_of_mean(
        _target_count(targets, mask, model.cfg.vocab_size), group)


def seq2seq_loss(model: Seq2SeqLM, group=None):
    """``loss_fn(batch, generator=None) -> (loss, {"perplexity"})`` for
    ``{"encoder_ids", "targets"}`` batches: the mean next-token NLL over
    non-pad targets (JAX ``seq2seq_loss``).  Over a data-parallel
    ``group`` the loss is this rank's share of the global mean and the
    metric its share of the log, ``log_perplexity``, as in
    :func:`..gpt.lm_loss`."""

    def loss_fn(batch, generator=None):
        _, targets, mask, loss = _teacher_forced(model, batch, False,
                                                 generator)
        if group is None:
            return loss, {"perplexity": torch.exp(loss.detach())}
        loss = _loss_share(model, loss, targets, mask, group)
        return loss, {"log_perplexity": loss.detach()}

    return loss_fn


def seq2seq_eval(model: Seq2SeqLM, group=None):
    """``metric_fn(batch) -> {"loss", "accuracy", "perplexity"}``:
    teacher-forced, deterministic, without autograd; the accuracy of
    :func:`..ops.xent.chunked_argmax`'s ids over the non-pad targets
    (JAX ``seq2seq_eval``).  Over a data-parallel ``group`` each is this
    rank's share of the global eval batch's (the perplexity as
    ``log_perplexity``)."""
    cfg = model.cfg

    def metric_fn(batch):
        with torch.no_grad():
            hidden, targets, mask, loss = _teacher_forced(model, batch, True,
                                                          None)
            shard = getattr(model.shared, "tp", None)
            pred = chunked_argmax(hidden, model.shared.weight,
                                  compute_dtype=cfg.dtype) if shard is None \
                else vocab_parallel_argmax(hidden, model.shared.weight,
                                           shard, compute_dtype=cfg.dtype)
        n = mask.sum()
        acc = ((pred == targets).float() * mask).sum() / n.clamp_min(1.0)
        if group is None:
            return {"loss": loss, "accuracy": acc,
                    "perplexity": torch.exp(loss)}
        loss = _loss_share(model, loss, targets, mask, group)
        return {"loss": loss, "accuracy": acc * share_of_mean(n, group),
                "log_perplexity": loss}

    return metric_fn


@torch.no_grad()
def seq2seq_generate(model: Seq2SeqLM, encoder_ids, *, max_new_tokens: int,
                     temperature: float = 0.0,
                     eos_token_id: int | None = None,
                     generator: torch.Generator | None = None
                     ) -> torch.Tensor:
    """Autoregressive decoding: encode once, prime the cache with BOS at
    position 0, then one cached decoder step a token.  Returns (B,
    max_new_tokens) ids (BOS excluded) on the model's device.

    ``temperature=0`` is greedy; otherwise samples draw from
    ``generator`` (on the model's device; by default one seeded with 0).
    ``eos_token_id`` freezes a row from its first eos (it keeps emitting
    eos).  Needs ``cfg.max_seq >= max_new_tokens + 1``.  Every step is a
    one-token step (K5 in each decoder layer on the card); the last
    token's step, whose hidden state nothing reads, is not run."""
    cfg = model.cfg
    if getattr(model.shared, "tp", None) is not None:
        raise NotImplementedError(
            "decoding a model split over a model axis is not ported")
    if cfg.max_seq < max_new_tokens + 1:
        raise ValueError(f"cfg.max_seq={cfg.max_seq} < 1+max_new_tokens="
                         f"{max_new_tokens + 1}; raise max_seq")
    dev = model.device
    enc = torch.as_tensor(encoder_ids, device=dev).long()
    b = enc.shape[0]
    greedy = float(temperature) <= 0.0
    if generator is None and not greedy:
        generator = torch.Generator(device=dev).manual_seed(0)
    eos = -1 if eos_token_id is None else int(eos_token_id)
    enc_out, enc_pad, enc_pos = model.encode(enc)
    cache = model.init_cache(b)
    tokens = torch.full((b, max_new_tokens + 1), cfg.bos_id,
                        dtype=torch.long, device=dev)
    hidden = model.decode(tokens[:, :1], enc_out, enc_pad, enc_pos,
                          positions=torch.zeros((b, 1), dtype=torch.long,
                                                device=dev), cache=cache)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    for t in range(max_new_tokens):
        logits = tied_head_logits(hidden[:, -1], model.shared.weight,
                                  cfg.dtype)
        nxt = _sample(logits, generator, float(temperature), greedy=greedy,
                      top_k=0)
        if eos >= 0:
            nxt = nxt.masked_fill(done, eos)
            done |= nxt == eos
        tokens[:, t + 1] = nxt
        if t + 1 < max_new_tokens:
            hidden = model.decode(
                nxt[:, None], enc_out, enc_pad, enc_pos,
                positions=torch.full((b, 1), t + 1, dtype=torch.long,
                                     device=dev), cache=cache)
    return tokens[:, 1:]
