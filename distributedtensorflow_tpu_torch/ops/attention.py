"""Attention ops.

Twin of ``distributedtensorflow_tpu/ops/attention.py``:

- :func:`dot_product_attention` (``:29-64``): the dispatch point of the
  training path.  ``"auto"`` takes the flash kernels (K2/K3,
  ``ops/flash_attention.py``) for CUDA tensors under the gate of
  ``flash_attention.supported``, ``"pallas"`` forces them (the plain
  twins on the CPU), ``"xla"`` is the caller's choice of
  :func:`xla_attention` (``:409``), the plain path.
- :func:`cached_decode_attention` (``:67-158``): one KV-cache step
  against the dense (B, Hkv, max_seq, D) cache.  Under
  :data:`DECODE_IMPL` ``"auto"`` a single new token goes through
  :func:`decode_attention`, whose CUDA route is the hand-written kernel
  ``csrc/decode_attention.cu`` (the port of the TPU kernel
  ``_decode_attn_kernel``, ``:279``), for any GQA group and any band;
  ``"xla"`` sends it, as prefill chunks always go, to the grouped matmul
  path.
- :func:`paged_decode_attention` (``:161-219``): the serving engine's
  decode step against the paged pool, a gather plus matmuls, and
  :func:`paged_verify_attention` (``:222-277``), its generalisation to a
  window of T query positions for speculative verification.  The JAX
  package has no kernel for either, so they stay plain PyTorch here.

Products of bf16 operands are taken in fp32 (``.float()`` on both
operands: the products are exact and the sums fp32), which is what the
JAX path's ``preferred_element_type=float32`` computes; a torch bf16
matmul would round its result to bf16 instead.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from . import _cuda
from ._cuda import SMEM_LIMIT
from . import flash_attention as _flash

#: Finite mask value: a fully masked row averages V instead of giving NaN.
NEG_INF = -1e9

DECODE_IMPLS = ("auto", "xla")


def decode_impl_from_env(environ) -> str:
    """The seed of :data:`DECODE_IMPL`: ``DTF_DECODE_IMPL`` in
    ``environ``, "auto" when unset (the JAX package's rule,
    ``ops/attention.py:26``)."""
    return environ.get("DTF_DECODE_IMPL", "auto")


#: Decode-step path of :func:`cached_decode_attention`: "auto" (a
#: one-token step takes :func:`decode_attention`, the kernel K5 on the
#: card) or "xla" (every step takes the grouped einsum path).  Seeded from
#: the environment; a mutable module global, read at every call, as in
#: the JAX package (callers and tests swap it).  Another value raises when
#: a step runs.
DECODE_IMPL = decode_impl_from_env(os.environ)

#: Streaming multiprocessors of an H100 SXM; :func:`decode_plan` splits
#: the band into as many blocks as :data:`_BLOCKS_PER_SM` a SM take in
#: one wave (the wrapper passes the card's own count).
H100_SMS = 132
_BLOCKS_PER_SM = 2
_WARPS = 8       # warps of a kernel block (csrc/decode_attention.cu)
_PASS = 8        # query heads one pass of the w.V product keeps in registers
_ROW_UNIT = 32   # a split's rows are a multiple of this (but the last)
_SIGNATURES = {"dtf_decode_attention": [ctypes.c_void_p] * 8
               + [ctypes.c_int] * 9 + [ctypes.c_float] + [ctypes.c_int] * 2
               + [ctypes.c_void_p]}


def dot_product_attention(q, k, v, *, mask=None, segment_ids=None,
                          causal=False, window=None, implementation="auto"):
    """Multi-head scaled dot-product attention of q (B, S, H, D) against
    k, v (B, S, Hkv, D).  ``mask`` broadcasts to (B, H, Sq, Sk), True =
    keep; ``segment_ids`` (B, S) restricts attention to packed segments;
    ``window`` (needs ``causal``) keeps keys in ``(i - window, i]``."""
    if implementation not in ("auto", "xla", "pallas"):
        raise ValueError(f"implementation={implementation!r}: expected "
                         "'auto', 'xla' or 'pallas'")
    if implementation == "pallas" or (implementation == "auto" and
                                      _flash.supported(
                                          q, k, v, mask=mask,
                                          segment_ids=segment_ids)):
        return _flash.flash_attention(q, k, v, mask=mask,
                                      segment_ids=segment_ids, causal=causal,
                                      window=window)
    if segment_ids is not None:
        seg = (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None]
        mask = seg if mask is None else torch.logical_and(mask, seg)
    return xla_attention(q, k, v, mask=mask, causal=causal, window=window)


def xla_attention(q, k, v, *, mask=None, causal=False, window=None):
    """BSHD attention by whole score tensors, with GQA through grouped
    products (K/V never widened to H heads).  As in JAX, the q.k product
    is rounded to the input dtype before the fp32 scale and softmax, the
    weights are rounded to it before the product with V, and every
    product sums in fp32 (see the module docstring)."""
    dtype = q.dtype
    b, sq, hq, depth = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, depth).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()).reshape(
        b, hq, sq, sk).to(dtype).float() * (1.0 / depth ** 0.5)
    if window is not None and not causal:
        raise ValueError("window (sliding-window attention) requires causal")
    if causal:
        keep = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        if window is not None:
            qp = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
            keep &= torch.arange(sk, device=q.device)[None, :] > qp - window
        scores = torch.where(keep, scores, NEG_INF)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    wg = weights.to(dtype).float().reshape(b, hkv, g, sq, sk)
    out = torch.einsum("bhgqk,bkhd->bqhgd", wg, v.float())
    return out.reshape(b, sq, hq, depth).to(dtype)


def cached_decode_attention(
    q: torch.Tensor,         # (B, s_new, H, D) new queries
    k_new: torch.Tensor,     # (B, s_new, Hkv, D) new keys (Hkv <= H: GQA)
    v_new: torch.Tensor,     # (B, s_new, Hkv, D) new values
    cached_k: torch.Tensor,  # (B, Hkv, max_seq, D) cache
    cached_v: torch.Tensor,  # (B, Hkv, max_seq, D)
    cache_index: int,        # next write slot
    window: int | None = None,  # sliding window (matches training masking)
):
    """Write the new K/V at ``cache_index`` and attend the new queries
    against the cache; returns ``(out, cached_k, cached_v, cache_index +
    s_new)``.  A query at absolute position ``ix + i`` sees keys at
    positions ``<= ix + i`` (and ``> ix + i - window`` with a window).

    The caller owns the cache; unlike the JAX twin, which returns new
    arrays, the K/V write goes into ``cached_k``/``cached_v`` in place and
    the same tensors are returned.  :data:`DECODE_IMPL` picks the path of
    a one-token step."""
    impl = DECODE_IMPL
    if impl not in DECODE_IMPLS:
        raise ValueError(f"DECODE_IMPL={impl!r}: expected one of "
                         f"{DECODE_IMPLS}")
    b, s_new, h, d = q.shape
    max_seq = cached_k.shape[2]
    ix = int(cache_index)
    if ix + s_new > max_seq:
        raise ValueError(
            f"cache of {max_seq} positions cannot take {s_new} more at {ix}")
    cached_k[:, :, ix:ix + s_new] = k_new.transpose(1, 2)
    cached_v[:, :, ix:ix + s_new] = v_new.transpose(1, 2)
    if s_new == 1 and impl == "auto":
        lo = 0 if window is None else max(ix - window + 1, 0)
        out = decode_attention(q, cached_k, cached_v, lo, ix + 1)
        return out, cached_k, cached_v, ix + 1
    h_kv = cached_k.shape[1]
    g = h // h_kv
    q_pos = ix + torch.arange(s_new, device=q.device)
    k_idx = torch.arange(max_seq, device=q.device)
    valid = k_idx[None, :] <= q_pos[:, None]  # (s_new, max_seq)
    if window is not None:
        valid &= k_idx[None, :] > q_pos[:, None] - window
    qg = q.reshape(b, s_new, h_kv, g, d).float()
    scores = torch.einsum(
        "bqhgd,bhkd->bhgqk", qg, cached_k.float()
    ).reshape(b, h, s_new, max_seq) / (d ** 0.5)
    scores = torch.where(valid[None, None], scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    wg = weights.to(q.dtype).reshape(b, h_kv, g, s_new, max_seq)
    out = torch.einsum("bhgqk,bhkd->bqhgd", wg.float(), cached_v.float())
    return out.reshape(b, s_new, h, d).to(q.dtype), cached_k, cached_v, \
        ix + s_new


def _paged_kv(k_pool, v_pool, block_tables):
    """Each slot's blocks gathered through its page-table row: fp32
    ``(B, Hkv, max_blocks * block_size, D)`` K and V."""
    b = block_tables.shape[0]
    _, block_size, h_kv, d = k_pool.shape
    cap = block_tables.shape[1] * block_size
    k = k_pool[block_tables].reshape(b, cap, h_kv, d).transpose(1, 2)
    v = v_pool[block_tables].reshape(b, cap, h_kv, d).transpose(1, 2)
    return k.float(), v.float()


def _paged_attend(q, k, v, lens):
    """One query a slot, ``q`` (B, H, D), against gathered fp32 K/V,
    positions ``>= lens`` masked: the fp32-softmax scaled dot product of
    the dense decode path, GQA grouped."""
    b, h, d = q.shape
    h_kv, cap = k.shape[1], k.shape[2]
    valid = torch.arange(cap, device=q.device)[None, :] < lens[:, None]
    g = h // h_kv
    qg = q.reshape(b, h_kv, g, d).float()
    scores = torch.einsum(
        "bhgd,bhkd->bhgk", qg, k).reshape(b, h, cap) / (d ** 0.5)
    scores = torch.where(valid[:, None, :], scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    wg = weights.to(q.dtype).reshape(b, h_kv, g, cap)
    out = torch.einsum("bhgk,bhkd->bhgd", wg.float(), v)
    return out.reshape(b, h, d).to(q.dtype)


def paged_decode_attention(
    q: torch.Tensor,             # (B, H, D) one new query per serving slot
    k_pool: torch.Tensor,        # (num_blocks, block_size, Hkv, D)
    v_pool: torch.Tensor,        # (num_blocks, block_size, Hkv, D)
    block_tables: torch.Tensor,  # (B, max_blocks) int physical block ids
    seq_lens: torch.Tensor,      # (B,) int valid tokens incl. this step's
) -> torch.Tensor:
    """Single-token attention against the paged pool: each slot gathers
    its blocks to a (Hkv, max_blocks * block_size, D) view, masks
    positions ``>= seq_lens`` and runs the fp32-softmax scaled dot
    product of the dense decode path (GQA grouped, the pool never
    broadcast to H)."""
    k, v = _paged_kv(k_pool, v_pool, block_tables)
    return _paged_attend(q, k, v, seq_lens)


def paged_verify_attention(
    q: torch.Tensor,             # (B, T, H, D) draft-window queries a slot
    k_pool: torch.Tensor,        # (num_blocks, block_size, Hkv, D)
    v_pool: torch.Tensor,        # (num_blocks, block_size, Hkv, D)
    block_tables: torch.Tensor,  # (B, max_blocks) int physical block ids
    attend_lens: torch.Tensor,   # (B,) int valid tokens for query 0
) -> torch.Tensor:
    """Multi-token attention against the paged pool (speculative
    verification; twin of ``ops/attention.py:222`` of the JAX package,
    which is a gather and einsums there too).  Query ``t`` of a slot sees
    ``attend_lens + t`` positions, causal inside the draft window.
    Returns ``(B, T, H, D)``.

    One gather, then each window position through the one-token form of
    :func:`paged_decode_attention`, so a verified position's output is
    the sequential decode step's.  JAX contracts the T queries in one
    einsum; on the card that batched fp32 product rounds differently from
    the one-token product, and the difference carried through gpt_small
    flips bf16 greedy near ties (``chip_smoke.py``'s ``verify_window``
    row measures both forms)."""
    k, v = _paged_kv(k_pool, v_pool, block_tables)
    return torch.stack([_paged_attend(q[:, t], k, v, attend_lens + t)
                        for t in range(q.shape[1])], dim=1)


def decode_attention(q, cached_k, cached_v, lo: int, hi: int) -> torch.Tensor:
    """One query per (b, h) against cache positions ``[lo, hi)``:
    ``q`` (B, 1, H, D), cache (B, Hkv, S, D); returns (B, 1, H, D).  A
    CUDA tensor launches the kernel, a CPU tensor takes the plain twin."""
    if q.device.type == "cpu":
        return _plain_decode_attention(q, cached_k, cached_v, lo, hi)
    return decode_attention_cuda(q, cached_k, cached_v, lo, hi)


def _plain_decode_attention(q, cached_k, cached_v, lo: int, hi: int):
    """PyTorch twin of the TPU kernel: scale * q.k over the whole cache,
    a shared (S,) validity band, fp32 softmax normalised before the cast
    to V's dtype, w.V with fp32 sums; query head h reads kv head
    h // group."""
    b, _, h, d = q.shape
    h_kv, s = cached_k.shape[1], cached_k.shape[2]
    g = h // h_kv
    qg = q[:, 0].reshape(b, h_kv, g, d).float()
    scores = torch.einsum(
        "bhgd,bhsd->bhgs", qg, cached_k.float()) * (1.0 / d ** 0.5)
    k_idx = torch.arange(s, device=q.device)
    valid = (k_idx >= lo) & (k_idx < hi)
    scores = torch.where(valid, scores, NEG_INF)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    w = (p / p.sum(dim=-1, keepdim=True)).to(cached_v.dtype)
    out = torch.einsum("bhgs,bhsd->bhgd", w.float(), cached_v.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def decode_smem_bytes(h: int, h_kv: int, d: int, chunk: int) -> int:
    """Dynamic shared memory of one kernel block for a split of ``chunk``
    rows: the larger of the two launches' needs.  The scores launch holds
    the group's queries and scores, ``g * (D + chunk)`` floats; the output
    launch the group's weights, the per-warp partial outputs of one pass
    of at most :data:`_PASS` heads, the group's global max and sum and a
    flag, ``g * chunk + 8 * min(g, 8) * D + 2 * g + 1`` floats."""
    g = h // h_kv
    scores = g * (d + chunk)
    output = g * chunk + _WARPS * min(g, _PASS) * d + 2 * g + 1
    return 4 * max(scores, output)


def decode_plan(b: int, h: int, h_kv: int, d: int, lo: int, hi: int,
                sms: int = H100_SMS) -> tuple[int, int]:
    """``(splits, chunk)``: how the kernel cuts the band ``[lo, hi)``.
    Split ``i`` takes the rows ``[lo + i * chunk, min(hi, lo + (i + 1) *
    chunk))``, so the splits cover the band exactly and none is empty.
    As many splits as keep ``B * Hkv * splits`` blocks within two a SM of
    ``sms`` (one wave: the output launch fits two blocks a SM), in chunks
    of whole :data:`_ROW_UNIT` rows (a short band takes one split), and
    more where a chunk's shared memory (:func:`decode_smem_bytes`) would
    pass :data:`SMEM_LIMIT`."""
    n = hi - lo
    if n <= 0:
        raise ValueError(f"empty band [{lo}, {hi})")
    want = max(1, sms * _BLOCKS_PER_SM // (b * h_kv))
    chunk = -(-n // want)
    chunk = -(-chunk // _ROW_UNIT) * _ROW_UNIT
    fixed = decode_smem_bytes(h, h_kv, d, 0)
    cap = (SMEM_LIMIT - fixed) // (4 * (h // h_kv))
    if cap < 1:
        raise ValueError(f"a group of {h // h_kv} query heads at D={d} "
                         f"needs {fixed} bytes of shared memory before any "
                         f"row; a block has {SMEM_LIMIT}")
    chunk = min(chunk, cap, n)
    return -(-n // chunk), chunk


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention_cuda(q, cached_k, cached_v, lo: int, hi: int):
    """Launch ``csrc/decode_attention.cu`` on the current stream.

    The port of ``_decode_attn_kernel``
    (``distributedtensorflow_tpu/ops/attention.py:279``).  Bound on the
    H100 by the K/V read: ``2 * B * Hkv * (hi - lo) * D * itemsize``
    bytes over 3.35 TB/s.  The band is split over blocks
    (:func:`decode_plan`); a scratch buffer from PyTorch's allocator holds
    the scores, each split's max and sum, its partial output and a
    counter per (batch, kv head).  Counts one launch per call (the
    kernel's two launches)."""
    if q.device.type != "cuda":
        raise ValueError(f"decode attention kernel needs CUDA, got {q.device}")
    b, one, h, d = q.shape
    if one != 1:
        raise ValueError(f"decode attention kernel takes one query, got {one}")
    if cached_k.shape != cached_v.shape or cached_k.dim() != 4 \
            or cached_k.shape[0] != b or cached_k.shape[3] != d:
        raise ValueError(
            f"cache shapes {tuple(cached_k.shape)}/{tuple(cached_v.shape)} do "
            f"not fit q {tuple(q.shape)}")
    h_kv, s = cached_k.shape[1], cached_k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or cached_k.dtype != q.dtype or cached_v.dtype != q.dtype:
        raise TypeError(
            f"decode attention kernel takes all-fp32 or all-bf16, got q "
            f"{q.dtype}, K {cached_k.dtype}, V {cached_v.dtype}")
    vec = 16 // q.element_size()
    if h % h_kv or d % vec or 32 % (d // vec):
        raise ValueError(
            f"decode attention kernel needs H % Hkv == 0 and D / {vec} "
            f"dividing 32; got H={h} Hkv={h_kv} D={d}")
    if not 0 <= lo < hi <= s:
        raise ValueError(f"attended band [{lo}, {hi}) is not inside [0, {s})")
    for t in (q, cached_k, cached_v):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                "decode attention kernel needs contiguous, 16-byte aligned "
                "tensors on one device")
    splits, chunk = decode_plan(b, h, h_kv, d, lo, hi,
                                _sm_count(q.device.index or 0))
    rows = b * h * splits
    # one fp32 buffer: stats (rows x 2), partials (rows x D), scores
    # (B, H, hi - lo), counters (B, Hkv)
    scratch = torch.empty(rows * (2 + d) + b * h * (hi - lo) + b * h_kv,
                          dtype=torch.float32, device=q.device)
    stats, partial = scratch[:2 * rows], scratch[2 * rows:(2 + d) * rows]
    scores = scratch[(2 + d) * rows:-b * h_kv]
    done = scratch[-b * h_kv:]
    out = torch.empty_like(q)
    lib = _cuda.load("decode_attention", _SIGNATURES)
    err = lib.dtf_decode_attention(
        q.data_ptr(), cached_k.data_ptr(), cached_v.data_ptr(),
        out.data_ptr(), scores.data_ptr(), stats.data_ptr(),
        partial.data_ptr(), done.data_ptr(), b, h, h_kv, s, d, lo, hi, chunk,
        splits, 1.0 / d ** 0.5, q.dtype == torch.bfloat16,
        q.device.index or 0, _cuda.stream_handle(q.device))
    _cuda.launches["decode_attention"] += 1
    _cuda.check(lib, err, "decode_attention")
    return out
