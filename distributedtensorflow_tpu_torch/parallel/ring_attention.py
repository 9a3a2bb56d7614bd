"""Sequence parallelism: ring attention and Ulysses all-to-all.

Twin of ``distributedtensorflow_tpu/parallel/ring_attention.py``.  Each
rank of a ``seq`` group holds one contiguous chunk of the sequence,
chunk i on the group's rank i (the layout ``P(..., "seq", ...)`` gives in
JAX), and every function here takes that rank's (B, S_loc, H, D) q, k, v
and the group (a process group or a mesh's ``seq_group``):

- :func:`ring_attention` (``:40``): the K/V chunks travel round the ring
  (:func:`..collectives.start_ring_shift`, ``lax.ppermute``'s twin, the
  next chunk's transfer started before this chunk's product and waited
  for after it) while each rank's queries stay.  ``impl="flash"`` runs
  each chunk through the flash kernels K2 (forward) and K3f/K3
  (backward) of ``ops.flash_attention`` as a
  :class:`torch.autograd.Function` (JAX's custom VJP ``_ring_flash``,
  ``:90-263``): the diagonal chunk causal, a past chunk not, a future
  chunk skipped; the forward merges the chunks' normalised outputs by
  their log-sum-exp (``:143-153``), the last chunk outside the loop so
  that no K/V travel after it, and the backward runs K3f/K3 per chunk
  from the *global* lse and ``delta = rowsum(dO * O)``, the dk/dv partial
  sums travelling with their K/V chunk for a whole cycle so that each
  lands on its home rank.  Packed ``segment_ids`` travel with their
  chunk and reach the kernels as ``kv_segment_ids``.  ``impl="xla"`` is
  the plain online-softmax ring (:func:`_ring_attention_xla`, ``:269``),
  differentiated by autograd through the shifts.  ``impl=None`` takes the
  kernels for a CUDA chunk that ``ops.flash_attention.supported`` takes
  (the twin of JAX's ``_on_tpu()`` gate, ``:62-85``: S_loc at least
  ``MIN_SEQ_FOR_PALLAS`` in multiples of 8, a head dim of ``HEAD_DIMS``).
- :func:`ulysses_attention` (``:334``): two all-to-alls trade the
  sequence split for a head split, each rank attends over the whole
  sequence for H/n heads through ``ops.attention.dot_product_attention``
  (the flash kernels on the card past the gate), and the output trades
  back.  The segment ids are gathered over the group.  Heads must divide
  over the group.
- :func:`sequence_parallel_attention_fn` (``:397``): the model's
  ``attn_fn`` bound to a mesh's ``seq`` group.  Under a ``model`` axis
  each rank holds its own heads already, so the ring turns only those
  (``:415-424``).

Over a group of one rank the ring is one diagonal chunk and Ulysses
plain attention.  Every collective is a group's own, so the ranks of the
tests are threads with gloo groups (``testing.run_mesh``) and on the card
processes; a CUDA tensor over gloo goes through the host.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from ..ops import flash_attention as fa
from ..ops.attention import dot_product_attention
from .collectives import (
    all_gather,
    all_to_all,
    resolve_group,
    ring_shift,
    start_ring_shift,
)

NEG_INF = -1e9


def _size_rank(group) -> tuple[int, int]:
    return (1, 0) if group is None else (group.size(), group.rank())


def flash_chunks_ok(q, k, v, segment_ids=None) -> bool:
    """The auto gate: the flash kernels take this rank's chunk (a CUDA
    tensor that ``ops.flash_attention.supported`` takes, equal q/k/v
    shapes)."""
    return q.shape == k.shape == v.shape and fa.supported(
        q, k, v, segment_ids=segment_ids)


def ring_attention(q, k, v, group=None, *, causal: bool = False,
                   impl: str | None = None, segment_ids=None):
    """Ring attention of this rank's (B, S_loc, H, D) chunk over the ranks
    of ``group`` (a process group or a mesh's ``seq_group``; the chunks in
    rank order make the sequence).  ``impl``: None (auto), "flash" (the
    kernels, their plain twins for CPU tensors) or "xla" (the plain
    online-softmax ring).  ``segment_ids`` (B, S_loc): this chunk's packed
    segments."""
    group = resolve_group(getattr(group, "seq_group", group))
    if impl is None:
        impl = "flash" if flash_chunks_ok(q, k, v, segment_ids) else "xla"
    if impl == "flash":
        return RingFlash.apply(q, k, v, segment_ids, group, bool(causal))
    if impl != "xla":
        raise ValueError(f"impl={impl!r}: expected None, 'flash' or 'xla'")
    return _ring_attention_xla(q, k, v, group, causal=causal,
                               segment_ids=segment_ids)


def _chunk_kind(causal: bool, my: int, step: int, n: int) -> str | None:
    """The chunk a rank holds at ring step ``step``: the one that started
    on rank ``(my - step) % n``; "diag" (causal within), "past" (every
    key before every query, or not causal) or None (a future chunk under
    the causal mask: nothing to compute)."""
    kidx = (my - step) % n
    if not causal or kidx < my:
        return "past"
    return "diag" if kidx == my else None


def _merge(m, l, acc, o_c, lse_c):
    """Fold one chunk's softmax-normalised ``o_c`` (B, S, H, D) and its
    ``lse_c`` (B, H, S) into the running max, sum and fp32 numerator."""
    m_new = torch.maximum(m, lse_c)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(lse_c - m_new)
    acc = acc * alpha.transpose(1, 2)[..., None] \
        + o_c.float() * beta.transpose(1, 2)[..., None]
    return m_new, l * alpha + beta, acc


class RingFlash(torch.autograd.Function):
    """The flash ring (JAX ``_ring_flash``): forward and backward per
    chunk through the flash kernels (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, seg, group, causal):
        n, my = _size_rank(group)
        b, s, h, d = q.shape
        m = torch.full((b, h, s), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device)
        chunk = [k, v] + ([seg] if seg is not None else [])
        for step in range(n):
            # the next chunk travels while this one is computed; none after
            # the last
            shift = start_ring_shift(chunk, group) if step < n - 1 else None
            kind = _chunk_kind(causal, my, step, n)
            if kind is not None:
                kc, vc = chunk[:2]
                o_c, lse_c = fa.flash_forward(
                    q, kc, vc, segment_ids=seg,
                    kv_segment_ids=chunk[2] if seg is not None else None,
                    causal=kind == "diag")
                m, l, acc = _merge(m, l, acc, o_c, lse_c)
            if shift is not None:
                chunk = shift.wait()
        out = (acc / l.transpose(1, 2)[..., None]).to(q.dtype)
        lse = m + torch.log(l)
        ctx.save_for_backward(q, k, v, seg, out, lse)
        ctx.group, ctx.causal = group, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, seg, out, lse = ctx.saved_tensors
        group, causal = ctx.group, ctx.causal
        n, my = _size_rank(group)
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        chunk = [k, v] + ([seg] if seg is not None else [])
        for step in range(n):
            shift = start_ring_shift(chunk, group) if step < n - 1 else None
            kind = _chunk_kind(causal, my, step, n)
            if kind is not None:
                kc, vc = chunk[:2]
                dq_c, dk_c, dv_c = fa.flash_backward(
                    q, kc, vc, g, lse, delta, segment_ids=seg,
                    kv_segment_ids=chunk[2] if seg is not None else None,
                    causal=kind == "diag")
                dq += dq_c.float()
                dk += dk_c.float()
                dv += dv_c.float()
            if n > 1:
                # the chunk's gradient sums go where the chunk goes: after
                # n moves they are back on its home rank
                dk, dv = start_ring_shift([dk, dv], group, tag=8).wait()
            if shift is not None:
                chunk = shift.wait()
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def _ring_attention_xla(q, k, v, group, *, causal: bool = False,
                        segment_ids=None):
    """The plain online-softmax ring (JAX ``_ring_attention_xla``): fp32
    scores per chunk with the causal mask by global position and the
    packed segments' mask at NEG_INF, K/V rotated by the differentiable
    :func:`..collectives.ring_shift`."""
    n, my = _size_rank(group)
    b, s, h, d = q.shape
    scale = 1.0 / d ** 0.5
    qf = q.float()
    m = torch.full((b, h, s, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device)
    kc, vc, seg_c = k, v, segment_ids
    pos = torch.arange(s, device=q.device)
    for step in range(n):
        sc = torch.einsum("bqhd,bkhd->bhqk", qf, kc.float()) * scale
        if causal:
            kidx = (my - step) % n
            keep = (my * s + pos)[:, None] >= (kidx * s + pos)[None, :]
            sc = torch.where(keep, sc, NEG_INF)
        if segment_ids is not None:
            same = segment_ids[:, :, None] == seg_c[:, None, :]
            sc = torch.where(same[:, None], sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha.permute(0, 2, 1, 3) + torch.einsum(
            "bhqk,bkhd->bqhd", p, vc.float())
        m = m_new
        if step < n - 1:
            kc, vc = ring_shift(kc, group), ring_shift(vc, group)
            if segment_ids is not None:
                seg_c = ring_shift(seg_c, group)
    # l >= 1: the diagonal chunk gives each row exp(0)
    return (acc / l.permute(0, 2, 1, 3)).to(q.dtype)


def ulysses_attention(q, k, v, group=None, *, causal: bool = False,
                      attn_fn: Callable | None = None, segment_ids=None):
    """Ulysses attention of this rank's (B, S_loc, H, D) chunk over the
    ranks of ``group``: all-to-all to (B, S, H/n, D), ``attn_fn`` over the
    whole sequence (default ``dot_product_attention``, causal as asked),
    all-to-all back.  ``segment_ids`` (B, S_loc) are gathered over the
    group.  Raises for heads that the group does not divide."""
    group = resolve_group(getattr(group, "seq_group", group))
    n, _ = _size_rank(group)
    h = q.shape[2]
    if h % n:
        raise ValueError(f"heads={h} not divisible by seq axis size {n}")
    if attn_fn is None:
        attn_fn = functools.partial(dot_product_attention, causal=causal)
    if segment_ids is not None:
        seg_full = all_gather(segment_ids, group, gather_axis=1)
        attn_fn = functools.partial(attn_fn, segment_ids=seg_full)

    def seq_to_heads(x):  # (B, S_loc, H, D) -> (B, S, H/n, D)
        return all_to_all(x, group, split_axis=2, concat_axis=1)

    def heads_to_seq(x):  # (B, S, H/n, D) -> (B, S_loc, H, D)
        return all_to_all(x, group, split_axis=1, concat_axis=2)

    return heads_to_seq(attn_fn(seq_to_heads(q), seq_to_heads(k),
                                seq_to_heads(v)))


SCHEMES = {"ring": ring_attention, "ulysses": ulysses_attention}


class SequenceParallelAttention:
    """A model's ``attn_fn`` over a mesh's ``seq`` group:
    ``attn(q, k, v, segment_ids=None)`` on this rank's chunk.  ``rank``
    and ``size`` are the rank's place on ``seq``: the model's loss takes
    the rank's slice of the sequence (``models.gpt``)."""

    def __init__(self, mesh, scheme: str = "ring", causal: bool = True):
        if scheme not in SCHEMES:
            raise ValueError(f"sp scheme {scheme!r}: expected one of "
                             f"{list(SCHEMES)}")
        self.scheme, self.causal = scheme, causal
        self.group = mesh.seq_group
        self.rank, self.size = mesh.coords["seq"], mesh.shape["seq"]

    def __call__(self, q, k, v, segment_ids=None):
        return SCHEMES[self.scheme](q, k, v, self.group, causal=self.causal,
                                    segment_ids=segment_ids)

    def __repr__(self):
        return (f"SequenceParallelAttention({self.scheme}, seq {self.rank}"
                f" of {self.size})")


def sequence_parallel_attention_fn(mesh, *, scheme: str = "ring",
                                   causal: bool = True
                                   ) -> SequenceParallelAttention:
    """The attention of a model whose sequence is split over ``mesh``'s
    ``seq`` axis (JAX ``sequence_parallel_attention_fn``): ring or
    Ulysses over the rank's chunk; over a ``seq`` axis of 1 plain
    attention through the same code."""
    return SequenceParallelAttention(mesh, scheme, causal)
