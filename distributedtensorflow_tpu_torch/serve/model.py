"""The serving engine's programs: chunked prefill, cache gather, paged
decode and the fused decode/verify fast path.

Twin of ``distributedtensorflow_tpu/serve/model.py``:

- :func:`make_prefill_fn`: one ``chunk``-wide slice of one prompt
  through the dense-cache model (:func:`models.generate.prefill`), then
  the chunk's K/V scattered into the slot's pool blocks.
- :func:`make_gather_cache_fn`: rebuild one slot's dense prefill cache
  from its pool blocks, so chunks of different requests can interleave.
- :func:`make_decode_fn`: one token for every slot against the paged
  pool; the host samples from its logits.
- :func:`make_fused_decode_fn`: the decode fast path: the forward for a
  window of ``draft + 1`` positions a slot, the K/V append of the
  committed token and every draft, verification through
  :func:`ops.attention.paged_verify_attention` and the fused sampler
  (:func:`serve.sampling.sample_burst`), returning only a small
  ``(tokens, counts)`` array and the next step's feed.

The decode programs share one forward (:func:`_paged_forward`), written
out here from the model's weights with every dtype choice of
``models/gpt.py`` kept line for line: bf16 matmuls, fp32 LayerNorm
statistics, ``ln_f`` to fp32, the fp32 tied head.  Its LayerNorms run
the LayerNorm kernel on the card.

The engine's dense prefill cache is ``GPTLM.init_cache(1, max_context)``
(the JAX ``make_prefill_cache`` builds the flax collection by hand; here
the model already owns the one cache layout).  :func:`reset_cache_index`
rewinds it for the next admission: stale K/V past the index is masked by
the causal rule.

The JAX programs take the pools as donated buffers and return updated
ones.  Here the pools are updated in place, by index assignment, and the
programs return only what the host reads.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..models.generate import prefill
from ..models.gpt import GPTConfig, GPTLM, rope, rope_tables
from ..ops.attention import paged_decode_attention, paged_verify_attention
from ..ops.layernorm import layer_norm
from ..ops.xent import tied_head_logits
from .sampling import sample_burst

__all__ = [
    "make_prefill_fn",
    "make_decode_fn",
    "make_fused_decode_fn",
    "make_gather_cache_fn",
    "reset_cache_index",
]


def _check_servable(cfg: GPTConfig) -> None:
    if cfg.attn_window is not None:
        raise ValueError(
            "the paged decode program does not implement sliding-window "
            "masking yet; serve with attn_window=None")
    if cfg.dropout_rate:
        raise ValueError("serving is deterministic; set dropout_rate=0")


def reset_cache_index(cache: dict) -> dict:
    """Rewind a prefill cache to position 0 (buffers reused in place)."""
    for layer in cache.values():
        layer["attn"]["cache_index"] = 0
    return cache


def _slot_positions(table_row: np.ndarray, positions: np.ndarray,
                    block_size: int, device) -> torch.Tensor:
    """Flat pool rows (block * block_size + offset) of a slot's positions."""
    idx = table_row[positions // block_size].astype(np.int64) * block_size \
        + positions % block_size
    return torch.from_numpy(idx).to(device)


def make_prefill_fn(cfg: GPTConfig, *, chunk: int, block_size: int):
    """``fn(model, k_pool, v_pool, cache, tokens, start, table_row,
    last_ix) -> last_logits``: ``tokens`` (1, chunk) on the device,
    ``start`` the chunk's first absolute position, ``table_row`` the
    slot's numpy page-table row, ``last_ix`` the in-chunk index whose
    logits the engine wants.  The chunk's K/V go from the dense cache
    into the slot's pool blocks, in place."""
    _check_servable(cfg)

    def prefill_chunk(model: GPTLM, k_pool, v_pool, cache, tokens, start: int,
                      table_row: np.ndarray, last_ix: int):
        dev = k_pool.device
        positions = (start + torch.arange(chunk, device=dev))[None, :]
        logits, cache = prefill(model, tokens, positions, cache=cache)
        num_layers, nb_total, bs, h_kv, d = k_pool.shape
        idx = _slot_positions(table_row, start + np.arange(chunk),
                              block_size, dev)
        with torch.no_grad():
            for pool, key in ((k_pool, "cached_key"), (v_pool, "cached_value")):
                new = torch.stack([
                    cache[f"h{i}"]["attn"][key][0, :, start:start + chunk]
                    .transpose(0, 1)  # (chunk, Hkv, D)
                    for i in range(num_layers)
                ])  # (L, chunk, Hkv, D)
                pool.view(num_layers, nb_total * bs, h_kv, d)[:, idx] = new
        return logits[0, last_ix]

    return prefill_chunk


def make_gather_cache_fn(cfg: GPTConfig, *, block_size: int):
    """``fn(k_pool, v_pool, cache, table_row, start) -> cache``: gather
    all ``max_seq`` positions of a slot through ``table_row`` into the
    dense cache (in place) and set ``cache_index = start``.  Positions
    ``>= start`` gather stale data that the causal rule masks until a
    chunk overwrites them."""
    _check_servable(cfg)

    @torch.no_grad()
    def gather_cache(k_pool, v_pool, cache, table_row: np.ndarray, start: int):
        num_layers, nb_total, bs, h_kv, d = k_pool.shape
        idx = _slot_positions(table_row, np.arange(cfg.max_seq), block_size,
                              k_pool.device)
        kf = k_pool.view(num_layers, nb_total * bs, h_kv, d)[:, idx]
        vf = v_pool.view(num_layers, nb_total * bs, h_kv, d)[:, idx]
        for i in range(num_layers):
            layer = cache[f"h{i}"]["attn"]
            # (max_seq, Hkv, D) -> (1, Hkv, max_seq, D), the dense layout
            layer["cached_key"][0].copy_(kf[i].transpose(0, 1))
            layer["cached_value"][0].copy_(vf[i].transpose(0, 1))
            layer["cache_index"] = int(start)
        return cache

    return gather_cache


def _paged_forward(cfg: GPTConfig, model: GPTLM, k_pool, v_pool, tokens,
                   positions, write_idx, attend):
    """The decode forward of ``tokens`` (B, T) at ``positions`` (B, T):
    each layer writes its K/V into the pool rows ``write_idx`` (B * T,)
    and attends through ``attend(q, k_layer, v_layer)`` ((B, T, H, D) ->
    (B, T, H, D)).  Returns ``ln_f`` of the last hidden states, fp32."""
    b, t = tokens.shape
    n_heads, h_kv, head_dim = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    hidden = cfg.hidden_size
    kv_width = h_kv * head_dim
    num_layers, nb_total, bs, _, _ = k_pool.shape
    kf = k_pool.view(num_layers, nb_total * bs, h_kv, head_dim)
    vf = v_pool.view(num_layers, nb_total * bs, h_kv, head_dim)
    tabs = rope_tables(positions, head_dim, cfg.rope_theta, cfg.dtype)

    def dense(x, weight):
        # flax nn.Dense(dtype=cfg.dtype, use_bias=False): both operands in
        # the compute dtype, default accumulation
        return F.linear(x, weight.to(cfg.dtype))

    x = model.wte.weight[tokens].to(cfg.dtype)  # (B, T, hidden)
    for layer, blk_mod in enumerate(model.h):
        attn = blk_mod.attn
        h = layer_norm(x, blk_mod.ln1.scale, blk_mod.ln1.bias, eps=1e-6)
        qkv = dense(h, attn.qkv.weight)
        q = qkv[..., :hidden].reshape(b, t, n_heads, head_dim)
        k = qkv[..., hidden:hidden + kv_width].reshape(b, t, h_kv, head_dim)
        v = qkv[..., hidden + kv_width:].reshape(b, t, h_kv, head_dim)
        q = rope(q, positions, cfg.rope_theta, tabs)
        k = rope(k, positions, cfg.rope_theta, tabs)
        kf[layer, write_idx] = k.reshape(b * t, h_kv, head_dim)
        vf[layer, write_idx] = v.reshape(b * t, h_kv, head_dim)
        out = attend(q, kf[layer].view(nb_total, bs, h_kv, head_dim),
                     vf[layer].view(nb_total, bs, h_kv, head_dim))
        x = x + dense(out.reshape(b, t, hidden).to(cfg.dtype),
                      attn.proj.weight)
        h = layer_norm(x, blk_mod.ln2.scale, blk_mod.ln2.bias, eps=1e-6)
        x = x + dense(F.gelu(dense(h, blk_mod.fc_in.weight),
                             approximate="tanh"), blk_mod.fc_out.weight)
    return layer_norm(x, model.ln_f.scale, model.ln_f.bias, eps=1e-6,
                      out_dtype=torch.float32)


def make_decode_fn(cfg: GPTConfig):
    """``fn(model, k_pool, v_pool, tokens, block_tables, seq_lens, active)
    -> logits`` (max_slots, V) fp32.  ``tokens`` (each slot's last
    token), ``block_tables``, ``seq_lens`` (resident tokens: the new one
    is written there and attends ``seq_len + 1`` positions) and
    ``active`` are device tensors.  Inactive slots write into the scratch
    block and their logits are discarded by the engine."""
    _check_servable(cfg)

    @torch.no_grad()
    def decode(model: GPTLM, k_pool, v_pool, tokens, block_tables, seq_lens,
               active):
        nb_total, bs = k_pool.shape[1], k_pool.shape[2]
        # the new token's pool row: active slots append at seq_len inside
        # their own pages, inactive slots hit the scratch block
        blk = block_tables.gather(1, (seq_lens // bs)[:, None])[:, 0]
        idx = torch.where(active, blk * bs + seq_lens % bs,
                          (nb_total - 1) * bs)
        attend_lens = torch.where(active, seq_lens + 1, 1)

        def attend(q, k_layer, v_layer):
            return paged_decode_attention(
                q[:, 0], k_layer, v_layer, block_tables, attend_lens,
            )[:, None]

        xf = _paged_forward(cfg, model, k_pool, v_pool, tokens[:, None],
                            seq_lens[:, None], idx, attend)
        return tied_head_logits(xf[:, 0], model.wte.weight, cfg.dtype)

    return decode


def make_fused_decode_fn(cfg: GPTConfig, *, block_size: int, draft: int = 0):
    """The decode fast path: forward, K/V append and sampling in one call;
    speculative with ``draft > 0``.

    ``fn(model, k_pool, v_pool, tokens, draft_lens, block_tables,
    seq_lens, active, seeds, prompt_lens, temperature, top_k,
    all_greedy=None) -> (packed, next_feed)`` with ``T = draft + 1``
    query positions a slot: ``tokens`` (B, T) column 0 each slot's last
    committed token, columns ``1..draft_lens`` its drafts, the rest
    padding.  K/V of the committed token and every real draft go to
    consecutive positions in the slot's pages (pad columns and inactive
    slots write the scratch block; rejected drafts leave K/V past the
    committed length, masked until overwritten).  One multi-token paged
    attention pass, causal inside the window, then
    :func:`serve.sampling.sample_burst` with each slot's seed.
    ``packed`` (B, T + 1) holds the emitted tokens and, last, their
    count; ``next_feed`` (B, 1) stays on the device as the next one-token
    call's ``tokens``.  ``draft=0`` is the one-token fused program, with
    the same signature."""
    _check_servable(cfg)
    t_width = draft + 1

    @torch.no_grad()
    def fused_decode(model: GPTLM, k_pool, v_pool, tokens, draft_lens,
                     block_tables, seq_lens, active, seeds, prompt_lens,
                     temperature, top_k, all_greedy=None):
        nb_total, bs = k_pool.shape[1], k_pool.shape[2]
        nb_table = block_tables.shape[1]
        cols = torch.arange(t_width, device=tokens.device)[None, :]
        positions = seq_lens[:, None] + cols                     # (B, T)
        valid_w = active[:, None] & (cols <= draft_lens[:, None])
        blk = block_tables.gather(
            1, torch.clamp(positions // bs, 0, nb_table - 1))
        idx = torch.where(valid_w, blk * bs + positions % bs,
                          (nb_total - 1) * bs)
        attend_lens = torch.where(active, seq_lens + 1, 1)

        def attend(q, k_layer, v_layer):
            return paged_verify_attention(q, k_layer, v_layer, block_tables,
                                          attend_lens)

        xf = _paged_forward(cfg, model, k_pool, v_pool, tokens, positions,
                            idx.reshape(-1), attend)
        logits = tied_head_logits(xf, model.wte.weight, cfg.dtype)
        # the emitted position of each slot's next sample (decode
        # invariant: seq_len = prompt + emitted - 1), derived here so the
        # host sends nothing for it
        sample_pos = torch.clamp(seq_lens - prompt_lens + 1, min=0)
        out, n_emitted, next_feed = sample_burst(
            logits, tokens, draft_lens, seeds, sample_pos, temperature,
            top_k, active, all_greedy=all_greedy)
        packed = torch.cat([out, n_emitted[:, None]], dim=1)
        return packed, next_feed[:, None]

    return fused_decode
