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
(the flash kernels K2/K3 on the card) or the model's ``attn_fn``
(``GPTLM(cfg, attn_fn)`` in JAX: ring or Ulysses attention over a
``seq`` axis, ``parallel.ring_attention``), block remat through
``torch.utils.checkpoint``, dropout from explicit seeds, and the
blockwise FFN (``ffn_chunk_size``).  The losses (:func:`lm_loss`,
:func:`lm_eval`) take the hidden states (``return_hidden=True``) to the
cross-entropy head that :func:`_pick_xent` picks: the fused head (K4f/
K4b) on the card, the chunked head on the CPU.  ``forward(...,
taps=dict)`` records each module's count of non-finite outputs
(``wte``, each ``h{i}``, ``ln_f``) for the NaN-provenance pass
(:func:`nan_taps`, ``obs.dynamics``), as flax's ``sow`` into the
``dynamics`` collection does.

Sequence parallelism: JAX hands the whole (B, S) batch to one program
and GSPMD decides the layout around the attention region.  Here each
``seq`` rank keeps its contiguous S/n slice of the sequence through the
whole block stack, so no activation of the full sequence exists on any
rank: the loss (:func:`_next_token_loss`) shifts the targets on the full
sequence, then cuts the rank's slice of tokens, positions (rotary
positions from ``rank * S/n``), targets and mask (the sequence's last
position predicts nothing), and the rank's loss is its share of the
global mean, whose gradients the train step sums over ``seq`` with the
batch axes (``parallel.mesh``'s ``group``).
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
from ..ops.fused_xent import fused_softmax_xent, vocab_parallel_xent
from ..ops.xent import chunked_softmax_xent, tied_head_logits
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
    sow_nonfinite,
)


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
    #: Quantised block matmuls (qkv, proj, fc_in, fc_out): None/"none",
    #: "int8", "int8_stochastic" or "fp8" (``ops.quant``).
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
    """``attn_fn`` (None: dense causal attention, flash-capable) replaces
    the training forward's attention, ``attn_fn(q, k, v)`` on (B, S, H,
    D) (``parallel.ring_attention.sequence_parallel_attention_fn``)."""

    def __init__(self, cfg: GPTConfig, device=None, attn_fn=None):
        super().__init__()
        self.cfg = cfg
        self.attn_fn = attn_fn
        self.n_heads, self.n_kv = cfg.num_heads, cfg.kv_heads
        self.q_width = cfg.num_heads * cfg.head_dim
        self.kv_width = cfg.kv_heads * cfg.head_dim
        self.qkv = dense(cfg.hidden_size, self.q_width + 2 * self.kv_width,
                         dtype=cfg.dtype, quant=cfg.quant, device=device)
        # the fused [q | k | v] blocks, which tensor parallelism cuts
        # head-major
        self.qkv.segments = (self.q_width, self.kv_width, self.kv_width)
        self.proj = dense(self.q_width, cfg.hidden_size, dtype=cfg.dtype,
                          quant=cfg.quant, device=device)

    def tp_bind(self, rank: int, n: int, group) -> None:
        """This rank's heads over a ``model`` group of ``n`` (the
        reference's manual-TP ``n_heads``/``n_kv``,
        ``models/gpt.py:227-233``)."""
        self.n_heads //= n
        self.n_kv //= n
        self.q_width //= n
        self.kv_width //= n

    def forward(self, x, positions, rope_tabs, cache: dict | None):
        """Attention over x (B, S, E): one cached step when ``cache`` is
        this layer's ``{"cached_key", "cached_value", "cache_index"}``
        (updated), causal self-attention over the sequence when None."""
        cfg = self.cfg
        b, s, _ = x.shape
        qkv = self.qkv(x)
        q = qkv[..., :self.q_width].reshape(b, s, self.n_heads, cfg.head_dim)
        k = qkv[..., self.q_width:self.q_width + self.kv_width].reshape(
            b, s, self.n_kv, cfg.head_dim)
        v = qkv[..., self.q_width + self.kv_width:].reshape(
            b, s, self.n_kv, cfg.head_dim)
        q = rope(q, positions, cfg.rope_theta, rope_tabs)
        k = rope(k, positions, cfg.rope_theta, rope_tabs)
        if self.attn_fn is not None:
            self._check_attn_fn(cache)
            out = self.attn_fn(q, k, v)
        elif cache is None:
            out = dot_product_attention(q, k, v, causal=True,
                                        window=cfg.attn_window,
                                        implementation=cfg.attn_impl)
        else:
            out, cache["cached_key"], cache["cached_value"], \
                cache["cache_index"] = cached_decode_attention(
                    q, k, v, cache["cached_key"], cache["cached_value"],
                    cache["cache_index"], window=cfg.attn_window)
        return self.proj(out.reshape(b, s, self.q_width))

    def _check_attn_fn(self, cache) -> None:
        """The reference's three refusals of a custom ``attn_fn``
        (``models/gpt.py:263-285``)."""
        if cache is not None:
            raise ValueError(
                "decode uses dense cached attention; a custom attn_fn (e.g. "
                "sequence-parallel) is not supported in decode mode: shard "
                "the batch, not the sequence, when serving")
        if self.n_kv != self.n_heads:
            raise ValueError(
                "GQA (kv_heads < num_heads) is not supported with a custom "
                "attn_fn (ring/Ulysses sequence parallelism assumes equal "
                "q/kv head counts): use the dense/flash path or set "
                "kv_heads=num_heads")
        if self.cfg.attn_window is not None:
            raise ValueError(
                "attn_window is not supported with a custom attn_fn "
                "(sequence-parallel attention masks per K/V chunk): use the "
                "dense/flash path")


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None, attn_fn=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = FusedLayerNorm(cfg.hidden_size, device=device)
        self.attn = CausalSelfAttention(cfg, device=device, attn_fn=attn_fn)
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
                           use_reentrant=False, preserve_rng_state=False)
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
    ``"cpu"``).  ``attn_fn``: every block's training attention (see
    :class:`CausalSelfAttention`); one with a ``size`` > 1 (a
    ``parallel.ring_attention.SequenceParallelAttention``) makes the
    losses take this rank's slice of the sequence."""

    def __init__(self, cfg: GPTConfig, *, device=None, attn_fn=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.attn_fn = attn_fn
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                device=device, dtype=torch.float32)
        self.h = nn.ModuleList(
            [GPTBlock(cfg, device=device, attn_fn=attn_fn)
             for _ in range(cfg.num_layers)])
        self.ln_f = FusedLayerNorm(cfg.hidden_size, out_dtype=torch.float32,
                                   device=device)
        number_quant_sites(self)

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
                return_hidden: bool = False, taps: dict | None = None):
        """Logits (B, S, V) fp32, or the final fp32 hidden states (B, S, E)
        with ``return_hidden``.  ``deterministic=False`` applies dropout,
        drawing one seed per block from ``generator`` (the step's
        ``DropoutKey``, or a CPU ``torch.Generator``) before the block
        runs, so block remat recomputes the same mask (the forward draws
        no other random numbers, so remat keeps no RNG state).  A
        ``taps`` dict receives the non-finite count of the output of
        ``wte``, each block ``h{i}`` and ``ln_f`` (training forward
        only)."""
        cfg = self.cfg
        if cache is not None and getattr(self.wte, "tp", None) is not None:
            raise NotImplementedError(
                "decoding a model split over a model axis is not ported "
                "(serving runs whole models)")
        if cache is None:
            bind_quant_seed(self, None if deterministic else generator)
        # gather, then cast: the same values as casting the whole table
        x = embed_rows(self.wte, input_ids).to(cfg.dtype)
        sow_nonfinite(taps, "wte", x)
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
                seed = draw_seed(generator)
            if remat:
                x = checkpoint(block, x, positions, tabs, None, seed,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = block(x, positions, tabs, None, seed)
            sow_nonfinite(taps, f"h{i}", x)
        x = sow_nonfinite(taps, "ln_f", self.ln_f(x))
        if return_hidden:
            return x
        if getattr(self.wte, "tp", None) is not None:
            raise NotImplementedError(
                "full logits of a vocab-sharded head; the losses take "
                "return_hidden=True")
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
    """The mean next-token loss of the rows in ``batch`` (:func:`head_loss`;
    with a data-parallel ``group``, this rank's share); a model split over
    ``seq`` runs this rank's slice of the sequence
    (:func:`sequence_slice`)."""
    ids = batch["input_ids"]
    mask = batch.get("mask")
    targets = ids[:, 1:]
    mask = mask[:, 1:] if mask is not None else None
    sp = getattr(model, "attn_fn", None)
    if getattr(sp, "size", 1) > 1:
        ids, kw["positions"], targets, mask = sequence_slice(
            ids, targets, mask, sp.rank, sp.size)
        hidden = model(ids, return_hidden=True, **kw)
    else:
        hidden = model(ids, return_hidden=True, **kw)[:, :-1]
    return head_loss(model, xent, hidden, targets, mask, group)


def head_loss(model, xent, hidden, targets, mask=None, group=None):
    """The mean masked NLL of ``hidden`` (B, T, E) against ``targets``
    through the tied head ``model.wte``; with a data-parallel ``group``,
    this rank's share of the mean over every rank's targets (the heads
    divide by the count of weighted targets, so the share scales by this
    rank's count over the global one)."""
    shard = getattr(model.wte, "tp", None)
    if shard is not None:
        # the vocab-sharded head: K4f/K4b on this rank's rows where the
        # fused head runs, their plain twins over token tiles for the
        # chunked heads (fp32 tiles, chunked_bf16 too)
        loss = vocab_parallel_xent(
            hidden, model.wte.weight, targets, mask, shard=shard,
            compute_dtype=model.cfg.dtype, kernels=xent is fused_softmax_xent)
    else:
        loss = xent(hidden, model.wte.weight, targets, mask,
                    compute_dtype=model.cfg.dtype)
    if group is None:
        return loss
    return loss * share_of_mean(_target_count(targets, mask,
                                              model.cfg.vocab_size), group)


def sequence_slice(ids, targets, mask, rank: int, n: int):
    """``(ids, positions, targets, mask)`` of ``seq`` rank ``rank`` of
    ``n``: its contiguous S/n slice of the (B, S) ``ids`` and their
    positions, and of the (B, S - 1) next-token ``targets`` and ``mask``
    (shifted on the whole sequence), padded at the end with a target of
    -1 (outside the vocabulary: weight 0) and a mask of 0, so that the
    last rank's last position predicts nothing."""
    b, s = ids.shape
    if s % n:
        raise ValueError(f"sequence length {s} does not split over seq={n}")
    lo, hi = rank * (s // n), (rank + 1) * (s // n)
    targets = torch.cat([targets, targets.new_full((b, 1), -1)], 1)[:, lo:hi]
    if mask is not None:
        mask = torch.cat([mask, mask.new_zeros((b, 1))], 1)[:, lo:hi]
    positions = torch.arange(lo, hi, device=ids.device).expand(b, hi - lo)
    return ids[:, lo:hi], positions, targets, mask


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


def lm_eval(model: GPTLM, group=None):
    """Eval metric_fn (JAX ``lm_eval``): ``metric_fn(batch) -> {"loss",
    "perplexity"}``, deterministic, without autograd.  Over a
    data-parallel ``group`` the loss is this rank's share of the global
    mean and the perplexity its share of the log, ``log_perplexity``, as
    in :func:`lm_loss` (``train.engine.make_eval_step`` sums them)."""
    xent = _pick_xent(model.cfg, model.device)

    def metric_fn(batch):
        with torch.no_grad():
            loss = _next_token_loss(model, xent, batch, group)
        if group is not None:
            return {"loss": loss, "log_perplexity": loss}
        return {"loss": loss, "perplexity": torch.exp(loss)}

    return metric_fn


#: The blocks' ``model``-axis rules: qkv and fc_in column-parallel, proj
#: and fc_out row-parallel.
GPT_BLOCK_RULES = (
    (r".*attn/qkv/kernel", P(None, "model")),
    (r".*attn/proj/kernel", P("model", None)),
    (r".*fc_in/kernel", P(None, "model")),
    (r".*fc_out/kernel", P("model", None)),
)


def gpt_layout() -> LayoutMap:
    """Megatron-style ``model``-axis rules for :class:`GPTLM` (JAX
    ``gpt_layout``, ``models/gpt.py:562-576``): :data:`GPT_BLOCK_RULES`
    and the tied embedding split by vocab rows."""
    return LayoutMap([(r".*wte/embedding", P("model", None)),
                      *GPT_BLOCK_RULES])


def nan_taps(model: GPTLM):
    """The NaN-provenance tap forward for ``obs.dynamics`` (JAX
    ``nan_taps``, ``models/gpt.py:444-469``): ``tap_fn(batch) ->
    {"NNN_module": nonfinite_count}`` whose keys carry the FORWARD
    position (``000_wte``, ``001_h0``, ..., ``00N_ln_f``), so that sorted
    order is forward order and the provenance binary search names the
    first module whose output went non-finite.  The model holds the
    parameters (JAX's ``tap_fn`` takes them as its first argument).  The
    deterministic forward, without dropout and without autograd (so
    without block remat), on the training path's kernels.  A model split
    over ``seq`` runs its rank's slice of the sequence, as its loss does
    (:func:`sequence_slice`), and the counts are summed over the ``seq``
    group, so every rank holds the whole sequence's (JAX's taps read the
    global array)."""
    order = (["wte"] + [f"h{i}" for i in range(model.cfg.num_layers)]
             + ["ln_f"])

    def tap_fn(batch):
        taps: dict = {}
        ids, kw = batch["input_ids"], {}
        sp = getattr(model, "attn_fn", None)
        split = getattr(sp, "size", 1) > 1
        if split:
            ids, kw["positions"], _, _ = sequence_slice(
                ids, ids[:, 1:], None, sp.rank, sp.size)
        with torch.no_grad():
            model(ids, deterministic=True, return_hidden=True, taps=taps,
                  **kw)
        names = [name for name in order if name in taps]
        counts = [taps[name] for name in names]
        if split and counts:
            counts = all_reduce(torch.stack(counts), sp.group).unbind(0)
        return {f"{order.index(name):03d}_{name}": c
                for name, c in zip(names, counts)}

    return tap_fn
