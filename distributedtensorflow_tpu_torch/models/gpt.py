"""GPT decoder LM: the serving (decode) and training forwards.

Twin of ``distributedtensorflow_tpu/models/gpt.py``: pre-LN blocks, a
fused qkv projection with the GQA column split, rotary embeddings,
tanh-approximated GELU, bf16 compute with fp32 LayerNorm statistics and
an fp32 tied head.

With a ``cache`` the model runs in decode mode (``GPTLM(decode=True)``
in JAX).  The KV cache is a plain dict that the caller owns, named like
the flax ``cache`` collection: ``cache["h{i}"]["attn"]`` holds
``cached_key`` and ``cached_value`` (B, Hkv, max_seq, D) and
``cache_index`` (an int), written in place.  Without one it runs the
training forward: causal attention through ``dot_product_attention``
(the flash kernels K2/K3 on the card), block remat through
``torch.utils.checkpoint``, dropout from explicit seeds, and the
blockwise FFN (``ffn_chunk_size``).  The losses (:func:`lm_loss`,
:func:`lm_eval`) take the hidden states (``return_hidden=True``) to the
cross-entropy head that :func:`_pick_xent` picks: the fused head (K4f/
K4b) on the card, the chunked head on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops.attention import cached_decode_attention, dot_product_attention
from ..ops.blockwise import blockwise_map
from ..ops.fused_xent import fused_softmax_xent
from ..ops.xent import chunked_softmax_xent, tied_head_logits
from ..parallel.collectives import share_of_mean
from .layers import FusedLayerNorm, dense, dropout


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    #: Blockwise FFN: > 0 runs the MLP over sequence chunks of this many
    #: tokens, each recomputed in the backward (``ops/blockwise.py``).
    ffn_chunk_size: int = 0
    max_seq: int = 2048
    dropout_rate: float = 0.0
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    #: Recompute each block in the backward (``torch.utils.checkpoint``).
    remat: bool = True
    #: Recompute only the attention op of each block in the backward.
    remat_attn: bool = False
    #: "auto" (the flash kernels on the card past the seq gate), "pallas"
    #: (the flash kernels, or their plain twins on the CPU) or "xla"
    #: (whole score tensors, the plain path).
    attn_impl: str = "auto"
    #: LM-head loss: "auto", "chunked", "chunked_bf16" or "fused"; see
    #: :func:`_pick_xent`.
    xent_impl: str = "auto"
    #: Sliding window: token i attends keys in ``(i - attn_window, i]``.
    attn_window: int | None = None
    #: Grouped-query attention: K/V heads (None = num_heads).
    num_kv_heads: int | None = None
    #: Quantised matmuls are not ported; only None / "none" is accepted.
    quant: str | None = None

    def __post_init__(self):
        kv = self.num_kv_heads
        if kv is not None and (kv <= 0 or self.num_heads % kv):
            raise ValueError(
                f"num_kv_heads={kv} must divide num_heads={self.num_heads}")
        if self.attn_window is not None and self.attn_window < 1:
            raise ValueError(
                f"attn_window={self.attn_window} must be >= 1 (None = full)")

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def gpt_small() -> GPTConfig:
    """GPT-2-small: 12 layers, hidden 768, 12 heads, vocab 50257."""
    return GPTConfig()


def gpt_medium() -> GPTConfig:
    """GPT-2-medium: 24 layers, hidden 1024, 16 heads."""
    return GPTConfig(hidden_size=1024, num_layers=24, num_heads=16,
                     intermediate_size=4096)


def gpt_tiny() -> GPTConfig:
    """Test-size config (2 layers, 128 hidden, short context)."""
    return GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                     num_heads=4, intermediate_size=256, max_seq=256,
                     remat=False)


def rope_tables(positions: torch.Tensor, d: int, theta: float, dtype):
    """Sign-folded (B, S, 1, D) cos/sin tables for :func:`rope`: trig in
    fp32, then cast to the compute dtype."""
    d_half = d // 2
    freqs = theta ** (
        -torch.arange(0, d_half, dtype=torch.float32, device=positions.device)
        / d_half)
    angles = positions[:, :, None].float() * freqs  # (B, S, Dh)
    cos, sin = torch.cos(angles), torch.sin(angles)
    cos_f = torch.cat([cos, cos], dim=-1)[:, :, None, :]
    sin_f = torch.cat([-sin, sin], dim=-1)[:, :, None, :]
    return cos_f.to(dtype), sin_f.to(dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         tables=None) -> torch.Tensor:
    """Rotate-half rotary embedding of (B, S, H, D), combined in
    ``x.dtype``.  The JAX twin swaps the halves with a 0/1 permutation
    matmul; the concatenation here gives the same values."""
    d = x.shape[-1]
    if tables is None:
        tables = rope_tables(positions, d, theta, x.dtype)
    cos_f, sin_f = (t.to(x.dtype) for t in tables)
    x_rot = torch.cat([x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos_f + x_rot * sin_f


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.q_width = cfg.num_heads * cfg.head_dim
        self.kv_width = cfg.kv_heads * cfg.head_dim
        self.qkv = dense(cfg.hidden_size, self.q_width + 2 * self.kv_width,
                         dtype=cfg.dtype, quant=cfg.quant, device=device)
        self.proj = dense(self.q_width, cfg.hidden_size, dtype=cfg.dtype,
                          quant=cfg.quant, device=device)

    def forward(self, x, positions, rope_tabs, cache: dict | None):
        """Attention over x (B, S, E): one cached step when ``cache`` is
        this layer's ``{"cached_key", "cached_value", "cache_index"}``
        (updated), causal self-attention over the sequence when None."""
        cfg = self.cfg
        b, s, _ = x.shape
        qkv = self.qkv(x)
        q = qkv[..., :self.q_width].reshape(b, s, cfg.num_heads, cfg.head_dim)
        k = qkv[..., self.q_width:self.q_width + self.kv_width].reshape(
            b, s, cfg.kv_heads, cfg.head_dim)
        v = qkv[..., self.q_width + self.kv_width:].reshape(
            b, s, cfg.kv_heads, cfg.head_dim)
        q = rope(q, positions, cfg.rope_theta, rope_tabs)
        k = rope(k, positions, cfg.rope_theta, rope_tabs)
        if cache is None:
            out = dot_product_attention(q, k, v, causal=True,
                                        window=cfg.attn_window,
                                        implementation=cfg.attn_impl)
        else:
            out, cache["cached_key"], cache["cached_value"], \
                cache["cache_index"] = cached_decode_attention(
                    q, k, v, cache["cached_key"], cache["cached_value"],
                    cache["cache_index"], window=cfg.attn_window)
        return self.proj(out.reshape(b, s, self.q_width))


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = FusedLayerNorm(cfg.hidden_size, device=device)
        self.attn = CausalSelfAttention(cfg, device=device)
        self.ln2 = FusedLayerNorm(cfg.hidden_size, device=device)
        self.fc_in = dense(cfg.hidden_size, cfg.intermediate_size,
                           dtype=cfg.dtype, quant=cfg.quant, device=device)
        self.fc_out = dense(cfg.intermediate_size, cfg.hidden_size,
                            dtype=cfg.dtype, quant=cfg.quant, device=device)

    def forward(self, x, positions, rope_tabs, cache: dict | None,
                dropout_seed: int | None = None):
        h = self.ln1(x)
        if cache is not None:
            a = self.attn(h, positions, rope_tabs, cache["attn"])
        elif self.cfg.remat_attn and torch.is_grad_enabled():
            a = checkpoint(self.attn, h, positions, rope_tabs, None,
                           use_reentrant=False)
        else:
            a = self.attn(h, positions, rope_tabs, None)
        x = x + a
        h = self.ln2(x)
        chunk = self.cfg.ffn_chunk_size
        if chunk > 0 and cache is None:
            if h.shape[1] % chunk:
                raise ValueError(
                    f"ffn_chunk_size={chunk} does not divide sequence "
                    f"length {h.shape[1]}; pick a divisor or pad")
            m = blockwise_map(self._mlp, h, chunk)
        else:
            m = self._mlp(h)
        return x + dropout(m, self.cfg.dropout_rate, dropout_seed)

    def _mlp(self, h):
        return self.fc_out(F.gelu(self.fc_in(h), approximate="tanh"))


class GPTLM(nn.Module):
    """Decoder-only LM over token ids, fp32 logits.

    ``forward(input_ids, positions=..., cache=...)`` runs the tokens
    through the KV cache (:meth:`init_cache` makes one) and returns
    (B, S, V) logits; without a cache it runs the training forward.
    Parameters live on ``device`` (``cuda`` unless the caller passes
    ``"cpu"``)."""

    def __init__(self, cfg: GPTConfig, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                device=device, dtype=torch.float32)
        self.h = nn.ModuleList(
            [GPTBlock(cfg, device=device) for _ in range(cfg.num_layers)])
        self.ln_f = FusedLayerNorm(cfg.hidden_size, out_dtype=torch.float32,
                                   device=device)

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    def init_cache(self, batch: int, max_seq: int | None = None) -> dict:
        """A zeroed dense cache for ``batch`` rows of ``max_seq``
        (default ``cfg.max_seq``) positions."""
        cfg = self.cfg
        shape = (batch, cfg.kv_heads, max_seq or cfg.max_seq, cfg.head_dim)
        return {
            f"h{i}": {"attn": {
                "cached_key": torch.zeros(shape, dtype=cfg.dtype,
                                          device=self.device),
                "cached_value": torch.zeros(shape, dtype=cfg.dtype,
                                            device=self.device),
                "cache_index": 0,
            }}
            for i in range(cfg.num_layers)
        }

    def forward(self, input_ids, *, positions=None, cache=None,
                deterministic: bool = True, generator=None,
                return_hidden: bool = False):
        """Logits (B, S, V) fp32, or the final fp32 hidden states (B, S, E)
        with ``return_hidden``.  ``deterministic=False`` applies dropout,
        drawing one seed per block from ``generator`` (a CPU
        ``torch.Generator``) before the block runs, so block remat
        recomputes the same mask."""
        cfg = self.cfg
        # gather, then cast: the same values as casting the whole table
        x = self.wte.weight[input_ids].to(cfg.dtype)
        if positions is None:
            positions = torch.arange(
                input_ids.shape[1], device=x.device).expand(input_ids.shape)
        tabs = rope_tables(positions, cfg.head_dim, cfg.rope_theta, cfg.dtype)
        remat = cache is None and cfg.remat and torch.is_grad_enabled()
        for i, block in enumerate(self.h):
            if cache is not None:
                x = block(x, positions, tabs, cache[f"h{i}"])
                continue
            seed = None
            if not deterministic and cfg.dropout_rate:
                seed = int(torch.randint(2**62, (), generator=generator))
            if remat:
                x = checkpoint(block, x, positions, tabs, None, seed,
                               use_reentrant=False)
            else:
                x = block(x, positions, tabs, None, seed)
        x = self.ln_f(x)
        if return_hidden:
            return x
        return tied_head_logits(x, self.wte.weight, cfg.dtype)


def _pick_xent(cfg: GPTConfig, device):
    """The LM-head loss for ``cfg.xent_impl`` on ``device``: "chunked"
    (fp32 logits tiles), "chunked_bf16" (bf16 tiles) or "fused" (the
    kernels K4f/K4b on the card, their plain twins on the CPU).  "auto"
    is "fused" on ``cuda`` and "chunked" elsewhere, as the JAX package
    picks the fused head on its accelerator (``gpt.py:512-515``)."""
    impl = cfg.xent_impl
    if impl == "auto":
        impl = "fused" if torch.device(device).type == "cuda" else "chunked"
    if impl == "fused":
        return fused_softmax_xent
    if impl == "chunked":
        return chunked_softmax_xent
    if impl == "chunked_bf16":
        return functools.partial(chunked_softmax_xent,
                                 logits_dtype=torch.bfloat16)
    raise ValueError(f"xent_impl={cfg.xent_impl!r}: expected 'auto', "
                     "'chunked', 'chunked_bf16', or 'fused'")


def _next_token_loss(model: GPTLM, xent, batch, group=None, **kw):
    """The mean next-token loss of the rows in ``batch``; with a
    data-parallel ``group``, this rank's share of the mean over every
    rank's rows (the heads divide by the count of weighted targets, so
    the share scales by this rank's count over the global one)."""
    ids = batch["input_ids"]
    hidden = model(ids, return_hidden=True, **kw)
    mask = batch.get("mask")
    targets = ids[:, 1:]
    mask = mask[:, 1:] if mask is not None else None
    loss = xent(hidden[:, :-1], model.wte.weight, targets, mask,
                compute_dtype=model.cfg.dtype)
    if group is None:
        return loss
    return loss * share_of_mean(_target_count(targets, mask,
                                              model.cfg.vocab_size), group)


def _target_count(targets, mask, vocab_size: int):
    """The heads' weight sum: targets in [0, V), times ``mask``."""
    w = (targets >= 0) & (targets < vocab_size)
    return (w if mask is None else w * mask).sum()


def lm_loss(model: GPTLM, group=None):
    """Next-token cross-entropy through the head :func:`_pick_xent` picks
    for the model's device (JAX ``lm_loss``): ``loss_fn(batch,
    generator=None) -> (loss, {"perplexity": ...})``;
    ``batch["input_ids"]`` (B, S), an optional ``batch["mask"]`` (B, S);
    the final position predicts nothing.  Over a data-parallel ``group``
    (a mesh or a process group) the loss is this rank's share of the
    global mean and the metric its share of the log-perplexity,
    ``log_perplexity`` (``train.engine.accumulate_gradients_dp``)."""
    xent = _pick_xent(model.cfg, model.device)

    def loss_fn(batch, generator=None):
        loss = _next_token_loss(model, xent, batch, group,
                                deterministic=False, generator=generator)
        if group is not None:
            return loss, {"log_perplexity": loss.detach()}
        return loss, {"perplexity": torch.exp(loss.detach())}

    return loss_fn


def lm_eval(model: GPTLM):
    """Eval metric_fn (JAX ``lm_eval``): ``metric_fn(batch) -> {"loss",
    "perplexity"}``, deterministic, without autograd."""
    xent = _pick_xent(model.cfg, model.device)

    def metric_fn(batch):
        with torch.no_grad():
            loss = _next_token_loss(model, xent, batch)
        return {"loss": loss, "perplexity": torch.exp(loss)}

    return metric_fn
