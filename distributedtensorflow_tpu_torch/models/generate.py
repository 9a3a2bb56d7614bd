"""Autoregressive generation through the dense KV cache.

Twin of ``distributedtensorflow_tpu/models/generate.py``: chunked
``prefill``, one-token ``decode_step`` and ``generate`` (greedy or
temperature / top-k / top-p sampling, eos freezing, ragged right-padded
prompts).  The JAX ``lax.scan`` is a Python loop here; every step is a
single-token ``decode_step``, so on the card each layer's attention runs
the decode-attention kernel.  Sampling draws from a ``torch.Generator``,
so sampled tokens match the JAX package only in distribution.
"""

from __future__ import annotations

import torch

from .gpt import GPTLM


@torch.no_grad()
def prefill(model: GPTLM, tokens, positions, *, cache=None):
    """Teacher-forced step of a token chunk (B, S) at ``positions``
    through the cache; returns ``(logits, cache)`` with the chunk's K/V
    appended.  ``cache=None`` makes a new cache of ``cfg.max_seq``."""
    if cache is None:
        cache = model.init_cache(tokens.shape[0])
    return model(tokens, positions=positions, cache=cache), cache


def decode_step(model: GPTLM, tokens, positions, cache):
    """One-token (B, 1) step against an existing cache."""
    return prefill(model, tokens, positions, cache=cache)


def _sample(logits, generator, temperature: float, *, greedy: bool,
            top_k: int, top_p: float = 1.0):
    """(B, V) logits -> (B,) token ids."""
    if greedy:
        return logits.argmax(dim=-1)
    logits = logits / max(temperature, 1e-6)
    sorted_desc = None
    if top_k > 0:
        topv = torch.topk(logits, top_k, dim=-1).values
        logits = logits.masked_fill(logits < topv[:, -1:], -1e9)
        sorted_desc = topv  # the only survivors, already descending
    if top_p < 1.0:
        # nucleus: the smallest descending-probability prefix with mass
        # >= top_p (the first token always kept)
        if sorted_desc is None:
            sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        kept = (torch.cumsum(probs, dim=-1) - probs) < top_p
        cutoff = torch.where(kept, sorted_desc, torch.inf).amin(
            dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff, -1e9)
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=generator)[:, 0]


@torch.no_grad()
def generate(
    model: GPTLM,
    prompt,                      # (B, P) right-padded token ids
    *,
    max_new_tokens: int,
    prompt_lens=None,            # (B,) true lengths; default P
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    eos_token_id: int | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Continuations of ``prompt``; returns (B, P + max_new_tokens) ids
    on the model's device.

    ``temperature=0`` is greedy.  ``eos_token_id`` freezes a sequence
    once it samples that token (it keeps emitting eos).  The cache needs
    ``cfg.max_seq >= P + max_new_tokens``.  ``generator`` (on the model's
    device) seeds sampling; by default a generator seeded with 0."""
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if eos_token_id is not None and eos_token_id < 0:
        raise ValueError(
            f"eos_token_id must be a valid token id, got {eos_token_id} "
            "(pass None to disable eos handling)")
    cfg = model.cfg
    dev = model.device
    prompt = torch.as_tensor(prompt, device=dev).long()
    b, p = prompt.shape
    total = p + max_new_tokens
    if cfg.max_seq < total:
        raise ValueError(
            f"cfg.max_seq={cfg.max_seq} < prompt+new={total}; raise max_seq")
    if prompt_lens is None:
        prompt_lens = torch.full((b,), p, device=dev)
    prompt_lens = torch.as_tensor(prompt_lens, device=dev).long()
    greedy = float(temperature) <= 0.0
    if generator is None and not greedy:
        generator = torch.Generator(device=dev).manual_seed(0)

    tokens = torch.cat(
        [prompt, torch.zeros((b, max_new_tokens), dtype=torch.long,
                             device=dev)], dim=1)
    logits, cache = prefill(model, tokens[:, :1],
                            torch.zeros((b, 1), dtype=torch.long, device=dev))
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    for t in range(total - 1):
        sampled = _sample(logits[:, -1], generator, float(temperature),
                          greedy=greedy, top_k=int(top_k), top_p=float(top_p))
        # inside its prompt a row is fed the prompt token, afterwards the
        # sample (teacher-forced prefill and decode in one loop)
        in_prompt = (t + 1) < prompt_lens
        if eos_token_id is not None:
            sampled = sampled.masked_fill(done, eos_token_id)
        nxt = torch.where(in_prompt, tokens[:, t + 1], sampled)
        if eos_token_id is not None:
            done |= ~in_prompt & (nxt == eos_token_id)
        tokens[:, t + 1] = nxt
        if t + 2 < total:  # the last step's logits would go unused
            logits, cache = decode_step(
                model, nxt[:, None],
                torch.full((b, 1), t + 1, dtype=torch.long, device=dev),
                cache)
    return tokens
