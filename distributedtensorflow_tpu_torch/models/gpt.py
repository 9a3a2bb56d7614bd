"""GPT decoder LM, decode mode: the serving half of the model.

Twin of ``distributedtensorflow_tpu/models/gpt.py`` in decode mode
(``GPTLM(decode=True)``): pre-LN blocks, a fused qkv projection with the
GQA column split, rotary embeddings, tanh-approximated GELU, bf16
compute with fp32 LayerNorm statistics and an fp32 tied head.

The KV cache is a plain dict that the caller owns, named like the flax
``cache`` collection: ``cache["h{i}"]["attn"]`` holds ``cached_key`` and
``cached_value`` (B, Hkv, max_seq, D) and ``cache_index`` (an int).  The
model writes it in place.  The training forward (no cache) needs the
flash-attention kernels and is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.attention import cached_decode_attention
from ..ops.xent import tied_head_logits
from .layers import FusedLayerNorm, dense


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_seq: int = 2048
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
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
                     num_heads=4, intermediate_size=256, max_seq=256)


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

    def forward(self, x, positions, rope_tabs, cache: dict):
        """One cached step over x (B, S, E); ``cache`` is this layer's
        ``{"cached_key", "cached_value", "cache_index"}``, updated."""
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
        out, cache["cached_key"], cache["cached_value"], \
            cache["cache_index"] = cached_decode_attention(
                q, k, v, cache["cached_key"], cache["cached_value"],
                cache["cache_index"], window=cfg.attn_window)
        return self.proj(out.reshape(b, s, self.q_width))


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.ln1 = FusedLayerNorm(cfg.hidden_size, device=device)
        self.attn = CausalSelfAttention(cfg, device=device)
        self.ln2 = FusedLayerNorm(cfg.hidden_size, device=device)
        self.fc_in = dense(cfg.hidden_size, cfg.intermediate_size,
                           dtype=cfg.dtype, quant=cfg.quant, device=device)
        self.fc_out = dense(cfg.intermediate_size, cfg.hidden_size,
                            dtype=cfg.dtype, quant=cfg.quant, device=device)

    def forward(self, x, positions, rope_tabs, cache: dict):
        x = x + self.attn(self.ln1(x), positions, rope_tabs, cache["attn"])
        h = self.ln2(x)
        return x + self.fc_out(F.gelu(self.fc_in(h), approximate="tanh"))


class GPTLM(nn.Module):
    """Decoder-only LM over token ids, fp32 logits, decode mode.

    ``forward(input_ids, positions=..., cache=...)`` runs the tokens
    through the KV cache (:meth:`init_cache` makes one) and returns
    (B, S, V) logits.  Parameters live on ``device`` (``cuda`` unless
    the caller passes ``"cpu"``)."""

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

    def forward(self, input_ids, *, positions=None, cache=None):
        if cache is None:
            raise NotImplementedError(
                "GPTLM runs in decode mode only (pass a cache from "
                "init_cache); the training forward needs the flash-attention "
                "kernels K2/K3, queued in ROADMAP.md")
        cfg = self.cfg
        # gather, then cast: the same values as casting the whole table
        x = self.wte.weight[input_ids].to(cfg.dtype)
        if positions is None:
            positions = torch.arange(
                input_ids.shape[1], device=x.device).expand(input_ids.shape)
        tabs = rope_tables(positions, cfg.head_dim, cfg.rope_theta, cfg.dtype)
        for i, block in enumerate(self.h):
            x = block(x, positions, tabs, cache[f"h{i}"])
        x = self.ln_f(x)
        return tied_head_logits(x, self.wte.weight, cfg.dtype)
