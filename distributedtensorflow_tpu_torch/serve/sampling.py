"""Decode-time sampling: the logits -> probabilities reference, the fused
sampler and rejection-sampling verification of a draft window.

Twin of ``distributedtensorflow_tpu/serve/sampling.py``:

- :func:`logits_to_probs`: the numpy reference (temperature scaling,
  dynamic per-row top-k through a sort threshold, fp32 softmax, the exact
  one-hot of the first argmax for greedy rows), which the engine's host
  sampler uses;
- :func:`sample_burst`: the fused sampler, torch ops on the logits'
  device (called inside ``serve.model.make_fused_decode_fn``): one token
  a slot, greedy or temperature/top-k, generalised to verifying a draft
  window by rejection sampling.  A draft token ``d`` proposed with
  certainty (the n-gram drafter, ``serve.draft``) is accepted with
  probability ``p(d)``, and on rejection the replacement is drawn from
  ``max(p - onehot(d), 0)`` renormalised, so every emitted token follows
  the target distribution ``p``.  At temperature 0 a draft is accepted
  iff it is the argmax, and the output is the sequential greedy path's
  token for token;
- :func:`sample_one`: the same on one logits row (the first token, at
  the end of a request's prefill, when the engine samples on the device).

Randomness, a deliberate difference from JAX: JAX folds each request's
``PRNGKey(seed)`` with the emitted position; the port cannot reproduce
those bits.  Here the two uniforms of the token at emitted position
``t`` are words 0 and 1 of Philox4x32-10 (``ops.dropout.philox4x32``)
keyed by the request's 64-bit seed, over the counter ``(t, 0,`` the
sampling site ``, 0)``: a pure function of (seed, position), computed
with integer torch ops on any device, so a seeded request draws the same
tokens wherever the same logits are, and nothing goes back to the host.
Word 0 decides a draft's acceptance; word 1 samples by the inverse CDF.
Keying by emitted position keeps a request's stream independent of how
many tokens each speculative step accepted.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.dropout import philox4x32

__all__ = ["logits_to_probs", "sample_burst", "sample_one", "seed_word",
           "uniforms"]

_M32 = 0xFFFFFFFF
#: Counter word 2 of the sampler's Philox draws (ASCII "SAMP"), apart
#: from the dropout sites'.
SAMPLE_SITE = 0x53414D50


def logits_to_probs(logits, temperature, top_k) -> np.ndarray:
    """``(..., V)`` logits -> fp32 probabilities.

    ``temperature`` and ``top_k`` broadcast against the leading dims.
    ``top_k=0`` disables truncation; ``temperature <= 0`` is greedy and
    returns the exact one-hot of the first argmax, so ties resolve as
    ``argmax`` does.  fp32 throughout, as the device sampler computes."""
    logits = np.asarray(logits, dtype=np.float32)
    v = logits.shape[-1]
    rows = logits.shape[:-1]
    t = np.broadcast_to(np.asarray(temperature, np.float32), rows)[..., None]
    k = np.broadcast_to(np.asarray(top_k, np.int32), rows)[..., None]
    scaled = logits / np.maximum(t, np.float32(1e-6))
    # dynamic per-row top-k: threshold at the k-th largest via one sort
    srt = np.sort(scaled, axis=-1)
    kth = np.take_along_axis(srt, np.clip(v - k, 0, v - 1), axis=-1)
    scaled = np.where((k > 0) & (scaled < kth), np.float32(-np.inf), scaled)
    p = np.exp(scaled - scaled.max(axis=-1, keepdims=True))
    soft = p / p.sum(axis=-1, keepdims=True)
    am = np.argmax(logits, axis=-1)
    onehot = (np.arange(v)[None, :] == np.reshape(am, (-1, 1))).reshape(
        logits.shape)
    return np.where(t <= 0, onehot.astype(np.float32), soft)


def _probs(logits: torch.Tensor, temperature: torch.Tensor,
           top_k: torch.Tensor) -> torch.Tensor:
    """:func:`logits_to_probs` in torch ops: ``logits`` (..., V) fp32,
    ``temperature``/``top_k`` broadcastable to the leading dims plus a
    trailing 1."""
    v = logits.shape[-1]
    scaled = logits / torch.clamp(temperature, min=1e-6)
    srt = torch.sort(scaled, dim=-1).values
    kth = torch.gather(srt, -1, torch.clamp(v - top_k, 0, v - 1).expand(
        *scaled.shape[:-1], 1))
    scaled = torch.where((top_k > 0) & (scaled < kth),
                         torch.full_like(scaled, -float("inf")), scaled)
    p = torch.exp(scaled - scaled.amax(dim=-1, keepdim=True))
    soft = p / p.sum(dim=-1, keepdim=True)
    onehot = torch.zeros_like(soft).scatter_(
        -1, logits.argmax(dim=-1, keepdim=True), 1.0)
    return torch.where(temperature <= 0, onehot, soft)


def seed_word(seed: int) -> int:
    """A request's seed as the int64 whose two's-complement bits are the
    seed modulo 2**64 (the Philox key's two 32-bit words)."""
    return (int(seed) + 2**63) % 2**64 - 2**63


def uniforms(seeds: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """``(B, T, 2)`` fp32 uniforms in [0, 1) for the tokens at emitted
    ``positions`` (B, T) of the requests with int64 ``seeds`` (B,): words
    0 and 1 of Philox4x32-10, 24 bits each."""
    pos = positions.to(torch.int64)
    counter = torch.stack([pos & _M32, (pos >> 32) & _M32,
                           torch.full_like(pos, SAMPLE_SITE),
                           torch.zeros_like(pos)], -1)
    key = ((seeds & _M32)[:, None], ((seeds >> 32) & _M32)[:, None])
    words = philox4x32(counter, key)[..., :2]
    return (words >> 8).to(torch.float32) * (2.0 ** -24)


def _categorical(u: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """One draw a row by the inverse CDF: the first token whose
    cumulative mass passes ``u`` times the total; tokens of zero mass
    are never drawn."""
    cdf = probs.cumsum(dim=-1)
    idx = (cdf <= u[..., None] * cdf[..., -1:]).sum(dim=-1)
    v = probs.shape[-1]
    last = v - 1 - (probs > 0).flip(-1).to(torch.int8).argmax(dim=-1)
    return torch.minimum(idx, last)


def sample_burst(logits, tokens, draft_lens, seeds, sample_pos, temperature,
                 top_k, active, all_greedy: bool | None = None):
    """Fused sampling and speculative verification, on the logits' device.

    ``B`` slots, ``T = 1 + max draft`` query positions:

    - ``logits`` ``(B, T, V)`` fp32: position ``i`` conditions on the
      last committed token plus drafts ``d_1..d_i``;
    - ``tokens`` ``(B, T)`` int64: ``[:, 0]`` each slot's last committed
      token, ``[:, 1:]`` the drafts;
    - ``draft_lens`` ``(B,)``: how many drafts are real;
    - ``seeds`` ``(B,)`` int64 request seeds (:func:`seed_word`),
      ``sample_pos`` ``(B,)`` the emitted position of each slot's next
      token;
    - ``temperature``/``top_k`` ``(B,)``, ``active`` ``(B,)`` bool;
    - ``all_greedy``: the caller's knowledge that every row is greedy
      (skips the probabilities); None reads it from ``temperature``.

    Returns ``(out_tokens (B, T), n_emitted (B,), next_feed (B,))``:
    ``out_tokens[b, :n]`` are the emitted tokens (the accepted draft
    prefix and one correction or bonus token, ``1 <= n <= draft_lens[b]
    + 1``), ``next_feed`` each slot's last emitted token (inactive slots
    pass their input through)."""
    b, t_width, v = logits.shape
    dev = logits.device
    argmx = logits.argmax(dim=-1)                                # (B, T)
    greedy = (temperature <= 0.0)[:, None]                       # (B, 1)
    drafts_pad = torch.cat(
        [tokens[:, 1:], torch.zeros((b, 1), dtype=tokens.dtype, device=dev)],
        dim=1)                                                   # (B, T)
    draft_mask = torch.arange(t_width - 1, device=dev)[None, :] \
        < draft_lens[:, None]
    if all_greedy is None:
        all_greedy = bool(greedy.all())

    def prefix_len(acc):
        return torch.cumprod(acc.to(torch.int64), dim=1).sum(dim=1)

    accepted = torch.zeros((b,), dtype=torch.int64, device=dev)
    if all_greedy:
        # accept iff the draft IS the argmax; emit argmaxes
        if t_width > 1:
            accepted = prefix_len((tokens[:, 1:] == argmx[:, :-1])
                                  & draft_mask)
        corr = argmx
    else:
        probs = _probs(logits.float(), temperature[:, None, None],
                       top_k[:, None, None])
        pos = sample_pos[:, None] + torch.arange(t_width, device=dev)[None, :]
        u = uniforms(seeds, pos)                                 # (B, T, 2)
        if t_width > 1:
            d = tokens[:, 1:]
            p_d = torch.gather(probs[:, :-1], -1, d[..., None])[..., 0]
            acc = torch.where(greedy, d == argmx[:, :-1], u[:, :-1, 0] < p_d)
            accepted = prefix_len(acc & draft_mask)
        # correction (a rejected draft: the residual max(p - onehot(d), 0)
        # renormalised) or bonus (every draft accepted: p) for every
        # position; position `accepted` is the one used.  p <= 1, so the
        # residual is p with the draft's entry zeroed.
        has_draft = torch.arange(t_width, device=dev)[None, :] \
            < draft_lens[:, None]
        at_draft = torch.gather(probs, -1, drafts_pad[..., None])
        resid = probs.scatter(
            -1, drafts_pad[..., None],
            torch.where(has_draft[..., None], torch.zeros_like(at_draft),
                        at_draft))
        denom = resid.sum(dim=-1, keepdim=True)
        # p == onehot(d) means an acceptance of probability 1; guard 0/0
        resid = torch.where(denom > 0, resid / torch.clamp(denom, min=1e-30),
                            probs)
        corr = torch.where(greedy, argmx, _categorical(u[..., 1], resid))
    i_idx = torch.arange(t_width, device=dev)[None, :]
    out = torch.where(i_idx < accepted[:, None], drafts_pad,
                      torch.where(i_idx == accepted[:, None], corr,
                                  torch.zeros_like(corr)))
    n_emitted = torch.where(active, accepted + 1, torch.zeros_like(accepted))
    last = torch.gather(out, 1, accepted[:, None])[:, 0]
    next_feed = torch.where(active, last, tokens[:, 0])
    return out, n_emitted, next_feed


def sample_one(logits_row: torch.Tensor, seed: int, index: int,
               temperature: float, top_k: int) -> int:
    """One token from one logits row with :func:`sample_burst`'s math and
    key schedule (emitted position ``index``), on the row's device."""
    dev = logits_row.device
    out, _, _ = sample_burst(
        logits_row.float().reshape(1, 1, -1),
        torch.zeros((1, 1), dtype=torch.int64, device=dev),
        torch.zeros((1,), dtype=torch.int64, device=dev),
        torch.tensor([seed_word(seed)], dtype=torch.int64, device=dev),
        torch.tensor([index], dtype=torch.int64, device=dev),
        torch.tensor([temperature], dtype=torch.float32, device=dev),
        torch.tensor([top_k], dtype=torch.int64, device=dev),
        torch.ones((1,), dtype=torch.bool, device=dev),
        all_greedy=temperature <= 0.0,
    )
    return int(out[0, 0])
