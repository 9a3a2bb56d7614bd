"""Pipeline parallelism over the ``pipe`` mesh axis: the schedules and
the executors that run them tick by tick.

Twin of ``distributedtensorflow_tpu/parallel/pipeline.py``.  The
schedules are plain copies: :data:`SCHEDULES`, the bubble fractions
(``:45``, ``:230``), :class:`FBSchedule`, ``_fb_units`` and
:func:`fb_schedule` (``:402-550``) with its static checks and its
``n_slots`` bound.  JAX runs a schedule as one ``lax.scan`` over the
ticks inside one SPMD program and differentiates it; here every stage is
a process (or a thread rank) that runs its own column of the schedule,
and at every tick, idle ticks included, all stages swap their handoffs
in lock step (``parallel.collectives.exchange``: the activation to the
next stage, the cotangent to the previous one, the ring wrapping from
the last stage to the first as JAX's ``perm_fwd`` does).

A stage holds ``n_virtual`` chunks (stage ``k = c*n + p`` of the model is
chunk ``c`` of stage ``p``); ``stage_fn(chunk, x)`` maps an activation to
one of the same shape, and the gradients are taken with respect to the
chunk's tensors (a module's parameters, or a list of tensors).

- GPipe (:func:`gpipe_forward`, :func:`gpipe_backward`): the forward
  ticks of ``pipeline_apply`` (``:64``) or, with ``n_virtual > 1``,
  ``circular_pipeline_apply`` (``:244``, rank 0's write-then-read wrap
  slot ``:281-289`` included), each unit's graph kept; then the reverse
  ticks, which run the units' backwards in the reverse order and pass
  the cotangents back the way the activations came.  This is what JAX's
  autodiff of the scan computes; :func:`pipeline_apply` and
  :func:`circular_pipeline_apply` wrap both in one
  ``torch.autograd.Function``.
- 1F1B and interleaved (:func:`pipeline_fb_step`, ``:553``): one forward
  unit and one backward unit a tick from :func:`fb_schedule`'s tables.
  A forward unit runs without autograd and saves its stage input in its
  act slot; a backward unit recomputes the stage from that slot under
  autograd and takes its gradients, so no more than ``sched.n_slots``
  stage inputs are alive on a rank.  The last stage seeds its cotangent
  from the in-tick loss head.

:func:`make_pipelined_fn` and :func:`stack_stage_params` are the generic
entry points (``:163``, ``:179``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .collectives import all_reduce, exchange, group_rank, group_size

#: Pipeline schedules.  ``gpipe`` (all forwards, then the backwards; with
#: ``n_virtual > 1`` the circular forward order) keeps O(n_micro)
#: microbatch activations alive across the backward.  The
#: forward/backward-interleaved schedules ``1f1b`` and ``interleaved``
#: (:func:`fb_schedule` + :func:`pipeline_fb_step`) bound the live stage
#: inputs at O(n_stages) / O(n_stages * n_virtual) slots.
SCHEDULES = ("gpipe", "1f1b", "interleaved")


def gpipe_bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """Idle fraction of the GPipe schedule: (S-1)/(M+S-1)."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


def circular_bubble_fraction(n_stages: int, n_microbatches: int,
                             n_virtual: int) -> float:
    """Idle fraction of the circular schedule: (n-1)/(v*M + n-1)."""
    return (n_stages - 1) / (n_virtual * n_microbatches + n_stages - 1)


# --- the tables of the 1F1B family (plain copies) ----------------------------


@dataclasses.dataclass(frozen=True)
class FBSchedule:
    """Static schedule tables for :func:`pipeline_fb_step`.

    Each table is an int32 ``(ticks, n_stages)`` array; column ``s`` is
    rank ``s``'s program.  Per tick a rank runs at most one forward unit
    (``f_*``: chunk, microbatch, act-slot to save the stage input into,
    whether the input comes from the microbatch buffer) and one backward
    unit (``b_*``: chunk, microbatch, act-slot to restore, whether the
    cotangent comes from the in-loop loss head).  ``n_slots`` is the exact
    peak number of saved stage inputs any rank holds."""

    n_stages: int
    n_micro: int
    n_virtual: int
    n_slots: int
    ticks: int
    tables: dict[str, np.ndarray]

    def bubble_fraction(self) -> float:
        """Idle fraction of the tick timeline: the ticks where a rank has
        no unit to run, forward and backward weighted equally."""
        busy = 2 * self.n_virtual * self.n_micro
        total = 2 * self.ticks
        return (total - busy) / total


def _fb_units(n: int, m_total: int, v: int, forward: bool) -> list:
    """Unit execution order for one rank: ``[(chunk, microbatch), ...]``
    (Megatron's interleaved grouping: microbatches advance in groups of
    ``n`` per chunk; the backward mirrors the chunk order)."""
    units = []
    for u in range(v * m_total):
        if v == 1:
            c, m = 0, u
        else:
            c = (u % (n * v)) // n
            m = (u // (n * v)) * n + (u % n)
        units.append((v - 1 - c, m) if (not forward and v > 1) else (c, m))
    return units


def fb_schedule(n_stages: int, n_microbatches: int,
                n_virtual: int = 1) -> FBSchedule:
    """Build (and statically validate) a 1F1B (``n_virtual == 1``) or
    interleaved-1F1B schedule (``n_microbatches`` a positive multiple of
    ``n_stages``).  Every wire hop, act-slot reuse and the peak-slot bound
    are checked here."""
    n, m_total, v = n_stages, n_microbatches, n_virtual
    if n < 1 or m_total < 1 or v < 1:
        raise ValueError(
            f"need n_stages>=1, n_microbatches>=1, n_virtual>=1; got "
            f"{n}/{m_total}/{v}")
    if v > 1 and (m_total % n or m_total < n):
        raise ValueError(
            f"interleaved schedule needs n_microbatches a positive "
            f"multiple of n_stages ({m_total} vs {n})")
    fwd = _fb_units(n, m_total, v, forward=True)
    bwd = _fb_units(n, m_total, v, forward=False)
    b0 = (v - 1) * n + (n - 1)
    ticks = b0 + (n - 1) + v * m_total
    shape = (ticks, n)
    tabs = {k: np.zeros(shape, np.int32)
            for k in ("f_on", "f_c", "f_m", "f_slot", "f_inp",
                      "b_on", "b_c", "b_m", "b_slot", "b_head")}
    n_slots = 0
    for s in range(n):
        fwd_tick = {}
        slot_of = {}
        free: list[int] = []
        next_slot = 0
        high = 0
        for t in range(ticks):
            u = t - s
            if 0 <= u < v * m_total:
                c, m = fwd[u]
                fwd_tick[(c, m)] = t
                slot = free.pop() if free else next_slot
                if slot == next_slot:
                    next_slot += 1
                slot_of[(c, m)] = slot
                high = max(high, next_slot)
                tabs["f_on"][t, s] = 1
                tabs["f_c"][t, s] = c
                tabs["f_m"][t, s] = m
                tabs["f_slot"][t, s] = slot
                tabs["f_inp"][t, s] = int(s == 0 and c == 0)
            w = t - b0 - (n - 1 - s)
            if 0 <= w < v * m_total:
                c, m = bwd[w]
                assert (c, m) in slot_of, (
                    f"rank {s}: backward of {(c, m)} at tick {t} before "
                    f"its forward")
                assert fwd_tick[(c, m)] <= t
                slot = slot_of.pop((c, m))
                free.append(slot)
                tabs["b_on"][t, s] = 1
                tabs["b_c"][t, s] = c
                tabs["b_m"][t, s] = m
                tabs["b_slot"][t, s] = slot
                tabs["b_head"][t, s] = int(s == n - 1 and c == v - 1)
        assert not slot_of, f"rank {s}: units never backwarded: {slot_of}"
        n_slots = max(n_slots, high)
    # Wire freshness: one recv buffer per direction, so every consumed
    # message must have been sent exactly one tick earlier by the ring
    # neighbour, carrying exactly the consumer's unit.
    for s in range(n):
        for t in range(ticks):
            if tabs["f_on"][t, s] and not tabs["f_inp"][t, s]:
                src = (s - 1) % n
                assert t >= 1 and tabs["f_on"][t - 1, src], (s, t)
                sent = (tabs["f_c"][t - 1, src], tabs["f_m"][t - 1, src])
                want = (tabs["f_c"][t, s], tabs["f_m"][t, s])
                if s > 0:
                    assert sent == want, (s, t, sent, want)
                else:  # wrap: rank n-1's chunk c-1 output feeds chunk c
                    assert sent == (want[0] - 1, want[1]), (s, t, sent, want)
            if tabs["b_on"][t, s] and not tabs["b_head"][t, s]:
                src = (s + 1) % n
                assert t >= 1 and tabs["b_on"][t - 1, src], (s, t)
                sent = (tabs["b_c"][t - 1, src], tabs["b_m"][t - 1, src])
                want = (tabs["b_c"][t, s], tabs["b_m"][t, s])
                if s < n - 1:
                    assert sent == want, (s, t, sent, want)
                else:  # wrap: rank 0's chunk c cotangent feeds chunk c-1
                    assert sent == (want[0] + 1, want[1]), (s, t, sent, want)
    return FBSchedule(n_stages=n, n_micro=m_total, n_virtual=v,
                      n_slots=n_slots, ticks=ticks, tables=tabs)


# --- executors ---------------------------------------------------------------


def chunk_tensors(chunk) -> list[torch.Tensor]:
    """The tensors a chunk's gradients are taken for: a module's
    parameters, or the tensors of a list (modules' parameters in it)."""
    if isinstance(chunk, nn.Module):
        return list(chunk.parameters())
    out = []
    for item in chunk:
        out.extend(item.parameters() if isinstance(item, nn.Module)
                   else [item])
    return out


def _add(acc: list | None, grads) -> list:
    """``acc + grads`` leaf by leaf (``acc`` None: the first)."""
    if acc is None:
        return list(grads)
    return [a + g for a, g in zip(acc, grads)]


def _zero_grads(chunk) -> list[torch.Tensor]:
    return [torch.zeros_like(t) for t in chunk_tensors(chunk)]


def _saved_high(stats: dict | None, live: int) -> None:
    """Record the high-water count of saved stage inputs in ``stats``."""
    if stats is not None:
        stats["saved_high"] = max(stats.get("saved_high", 0), live)


@dataclasses.dataclass
class GPipeRun:
    """One forward of the GPipe schedule, kept for its reverse ticks: the
    stage, the schedule's sizes, each unit's ``(input, output)`` under
    autograd by ``(chunk, microbatch)``."""

    stage_fn: Callable
    chunks: Sequence
    group: Any
    n_micro: int
    n_virtual: int
    act: torch.Tensor  # a zero activation: the idle ticks' payload
    saved: dict


def gpipe_forward(stage_fn: Callable, chunks: Sequence,
                  microbatches: torch.Tensor, group, *,
                  wire_dtype=None, grad: bool = True, remat: bool = False,
                  stats: dict | None = None, on_unit=None):
    """The forward ticks of GPipe (one chunk a stage) or of the circular
    schedule (``len(chunks)`` > 1): stage ``k = c*n + p`` of microbatch
    ``m`` runs at tick ``c*M + m + p`` on stage ``p``; rank 0 takes chunk
    0's inputs from ``microbatches`` (n_micro, mb, ...) and chunk ``c``'s
    from its wrap buffer, where the last stage's chunk ``c - 1`` outputs
    wait (written before they are read, so ``n_micro == n`` is legal).
    ``wire_dtype`` casts the activations' payload on the wire only.

    Returns ``(outputs, run)``: the last stage's outputs (n_micro, mb,
    ...), zeros on the other stages, and with ``grad`` the
    :class:`GPipeRun` that :func:`gpipe_backward` takes (each unit's
    input a leaf of its own graph; ``remat`` recomputes the stage in the
    backward, ``torch.utils.checkpoint``), else None.  ``stats``
    receives ``saved_high``, the most stage inputs held at once;
    ``on_unit(m)`` is called before each unit of microbatch ``m`` runs."""
    n, s = group_size(group), group_rank(group)
    v = len(chunks)
    m_total = microbatches.shape[0]
    if v > 1 and m_total < n:
        raise ValueError(
            f"circular schedule needs n_micro >= n_ranks ({m_total} < {n})")
    act = torch.zeros_like(microbatches[0])
    recv = act
    circ = [act] * m_total  # rank 0's wrap slots
    outputs = torch.zeros_like(microbatches)
    saved = {}
    for t in range(v * m_total + n - 1):
        if s == 0 and v > 1 and t >= n:
            circ[(t - n) % m_total] = recv  # write, then read
        rel = t - s
        y = act
        if 0 <= rel < v * m_total:
            c, m = divmod(rel, m_total)
            x = recv if s > 0 else microbatches[m] if c == 0 else circ[m]
            if on_unit is not None:
                on_unit(m)
            if grad:
                x = x.detach().requires_grad_(True)
                with torch.enable_grad():
                    if remat:
                        y = checkpoint(stage_fn, chunks[c], x,
                                       use_reentrant=False)
                    else:
                        y = stage_fn(chunks[c], x)
                saved[(c, m)] = (x, y)
                _saved_high(stats, len(saved))
                y = y.detach()
            else:
                with torch.no_grad():
                    y = stage_fn(chunks[c], x)
            if s == n - 1 and c == v - 1:
                outputs[m] = y
        recv, _ = exchange(y, None, group, next_wire=wire_dtype)
    run = GPipeRun(stage_fn, chunks, group, m_total, v, act, saved) \
        if grad else None
    return outputs, run


def gpipe_backward(run: GPipeRun, g_outputs: torch.Tensor | None, *,
                   wire_dtype=None, on_chunk_done=None, on_unit=None):
    """The reverse ticks of :func:`gpipe_forward`'s run: at reverse tick
    ``t`` each stage runs the backward of the unit it ran at forward tick
    ``t``, its cotangent the last stage's ``g_outputs`` (n_micro, mb,
    ...; read on the last stage only) for the last chunk, the next
    stage's input gradient otherwise (the last stage keeps rank 0's,
    which come back through the wrap, until their unit's turn), and hands
    its input gradient to the previous stage (``wire_dtype`` on that
    wire, as JAX's autodiff transposes the forward's cast).  Returns
    ``(d_microbatches, grads)``: rank 0's gradients of the microbatches
    (zeros elsewhere) and, for each chunk, the gradients of its tensors
    summed over the microbatches.  ``on_chunk_done(c, grads)`` is called
    as soon as chunk ``c``'s last unit has run its backward (its
    gradients final while later ticks run), ``on_unit(m)`` before each
    unit's backward of microbatch ``m``."""
    group, chunks = run.group, run.chunks
    n, s = group_size(group), group_rank(group)
    m_total, v = run.n_micro, run.n_virtual
    ticks = v * m_total + n - 1
    d_mb = torch.zeros((m_total, *run.act.shape), dtype=run.act.dtype,
                       device=run.act.device)
    grads: list = [None] * v
    done = [0] * v
    wrap: dict = {}
    recv = None
    for t in reversed(range(ticks)):
        first = t + 1  # rank 0's unit at forward tick t + 1
        if s == n - 1 and recv is not None and m_total <= first \
                < v * m_total:
            wrap[(first // m_total - 1, first % m_total)] = recv
        rel = t - s
        dx = run.act
        if 0 <= rel < v * m_total:
            c, m = divmod(rel, m_total)
            if s == n - 1:
                ct = g_outputs[m] if c == v - 1 else wrap.pop((c, m))
            else:
                ct = recv
            x, y = run.saved.pop((c, m))
            params = chunk_tensors(chunks[c])
            if on_unit is not None:
                on_unit(m)
            dx, *gs = torch.autograd.grad(y, [x, *params], ct,
                                          materialize_grads=True)
            grads[c] = _add(grads[c], gs)
            done[c] += 1
            if on_chunk_done is not None and done[c] == m_total:
                on_chunk_done(c, grads[c])
            if s == 0 and c == 0:
                d_mb[m] = dx
        _, recv = exchange(None, dx, group, prev_wire=wire_dtype)
    return d_mb, [_zero_grads(chunks[c]) if g is None else g
                  for c, g in enumerate(grads)]


class _GPipe(torch.autograd.Function):
    """GPipe or the circular schedule as one autograd node: the forward
    ticks in the forward, the reverse ticks in the backward.  Every stage
    returns the last stage's outputs and computes the same loss from
    them; the backward seeds the reverse ticks from the last stage's
    gradient and gives every stage the microbatches' gradient (rank 0's,
    broadcast)."""

    @staticmethod
    def forward(ctx, stage_fn, chunks, group, wire_dtype, remat,
                microbatches, *tensors):
        outputs, run = gpipe_forward(stage_fn, chunks, microbatches, group,
                                     wire_dtype=wire_dtype, remat=remat)
        ctx.run, ctx.wire_dtype = run, wire_dtype
        return all_reduce(outputs, group)

    @staticmethod
    def backward(ctx, g):
        d_mb, grads = gpipe_backward(ctx.run, g.contiguous(),
                                     wire_dtype=ctx.wire_dtype)
        d_mb = all_reduce(d_mb, ctx.run.group) \
            if ctx.needs_input_grad[5] else None
        ctx.run = None
        return (None,) * 5 + (d_mb, *[x for gs in grads for x in gs])


def pipeline_apply(stage_fn: Callable, chunk, microbatches: torch.Tensor,
                   group, *, remat: bool = False, wire_dtype=None):
    """``pipeline_apply`` (``parallel/pipeline.py:64``): GPipe over the
    stages of ``group`` (a mesh's ``pipe_group``), this stage's ``chunk``
    and ``microbatches`` (n_micro, mb, ...) the same on every stage.
    Returns the last stage's outputs on every stage; differentiable with
    respect to the chunk's tensors and the microbatches (each stage's
    gradients those of the loss every stage computes from the outputs).
    ``remat`` recomputes each unit in the backward; ``wire_dtype`` casts
    the handoffs' payload only."""
    return circular_pipeline_apply(stage_fn, [chunk], microbatches, group,
                                   remat=remat, wire_dtype=wire_dtype)


def circular_pipeline_apply(stage_fn: Callable, chunks: Sequence,
                            microbatches: torch.Tensor, group, *,
                            remat: bool = False, wire_dtype=None):
    """``circular_pipeline_apply`` (``parallel/pipeline.py:244``): the
    circular schedule over this stage's ``chunks`` (chunk ``c`` is stage
    ``c*n + p`` of the model); needs ``n_micro >= n_stages``.  As
    :func:`pipeline_apply` otherwise."""
    tensors = [t for c in chunks for t in chunk_tensors(c)]
    return _GPipe.apply(stage_fn, list(chunks), group, wire_dtype, remat,
                        microbatches, *tensors)


def pipeline_fb_step(stage_fn: Callable, head_fn: Callable, chunks: Sequence,
                     head, microbatches: torch.Tensor, labels,
                     sched: FBSchedule, group, *,
                     cotangent_scale: float = 1.0, wire_dtype=None,
                     stats: dict | None = None, on_chunk_done=None,
                     on_unit=None):
    """One fused forward and backward pass of the 1F1B or interleaved
    schedule (``parallel/pipeline.py:553``), this stage's column of
    ``sched``.  Per tick the stage runs its forward unit (``stage_fn`` on
    the microbatch or the received activation, without autograd, the
    stage input saved in its act slot) and its backward unit (the stage
    recomputed under autograd from the saved input, its cotangent the
    next stage's input gradient or, at the last stage's last chunk,
    ``head_fn(head, y, labels[m])``, one microbatch's mean loss, seeded
    with ``cotangent_scale``), then exchanges the activation (payload in
    ``wire_dtype``) and the input gradient (full precision, as JAX's).

    Returns ``(loss_sum, grads, head_grads, dx0)``: the sum of the head's
    unscaled losses (the last stage's; 0 elsewhere), each chunk's
    gradients, the head tensors' (``chunk_tensors(head)``; None on a
    stage that ran no head unit) and rank 0's gradients of the
    microbatches, all per stage: the caller sums what is replicated.
    ``stats`` receives ``saved_high``, the most stage inputs held at once
    (``sched.n_slots`` at most); ``on_chunk_done(c, grads)`` is called
    as soon as chunk ``c``'s last backward unit has run, ``on_unit(m)``
    before each unit (forward or backward) of microbatch ``m``."""
    n, s = sched.n_stages, group_rank(group)
    if group_size(group) != n:
        raise ValueError(f"schedule of {n} stages over a group of "
                         f"{group_size(group)}")
    tabs = {k: v[:, s].tolist() for k, v in sched.tables.items()}
    last_b = {tabs["b_c"][t]: t for t in range(sched.ticks)
              if tabs["b_on"][t]}
    act = torch.zeros_like(microbatches[0])
    recv_f = recv_b = act
    acts: list = [None] * sched.n_slots
    live = 0
    grads: list = [None] * len(chunks)
    head_tensors = chunk_tensors(head)
    d_head = None
    dx0 = torch.zeros_like(microbatches)
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=microbatches.device)
    seed = torch.tensor(cotangent_scale, dtype=torch.float32,
                        device=microbatches.device)
    for t in range(sched.ticks):
        y = act
        if tabs["f_on"][t]:
            m = tabs["f_m"][t]
            x = microbatches[m] if tabs["f_inp"][t] else recv_f
            if on_unit is not None:
                on_unit(m)
            with torch.no_grad():
                y = stage_fn(chunks[tabs["f_c"][t]], x)
            acts[tabs["f_slot"][t]] = x
            live += 1
            _saved_high(stats, live)
        dx = act
        if tabs["b_on"][t]:
            c, m, slot = tabs["b_c"][t], tabs["b_m"][t], tabs["b_slot"][t]
            x = acts[slot].detach().requires_grad_(True)
            acts[slot] = None
            live -= 1
            params = chunk_tensors(chunks[c])
            if on_unit is not None:
                on_unit(m)
            with torch.enable_grad():
                yb = stage_fn(chunks[c], x)
                if tabs["b_head"][t]:
                    loss_u = head_fn(head, yb, labels[m])
                    dx, *gs = torch.autograd.grad(
                        loss_u, [x, *params, *head_tensors], seed,
                        materialize_grads=True)
                    gs, hs = gs[:len(params)], gs[len(params):]
                    d_head = _add(d_head, hs)
                    loss_sum = loss_sum + loss_u.detach().float()
                else:
                    dx, *gs = torch.autograd.grad(yb, [x, *params], recv_b,
                                                  materialize_grads=True)
            grads[c] = _add(grads[c], gs)
            if on_chunk_done is not None and last_b[c] == t:
                on_chunk_done(c, grads[c])
            if s == 0 and c == 0:
                dx0[m] += dx
        recv_f, recv_b = exchange(y, dx, group, next_wire=wire_dtype)
    grads = [_zero_grads(chunks[c]) if g is None else g
             for c, g in enumerate(grads)]
    return loss_sum, grads, d_head, dx0


# --- generic entry points ----------------------------------------------------


def make_pipelined_fn(stage_fn: Callable, mesh, *, n_microbatches: int,
                      remat: bool = False, wire_dtype=None) -> Callable:
    """``fn(chunks, batch) -> outputs`` (``make_pipelined_fn`` and, for
    several chunks a stage, ``make_circular_pipelined_fn``,
    ``parallel/pipeline.py:163,339``): ``batch`` (B, ...) is this
    replica's, cut into ``n_microbatches``; ``chunks`` this stage's
    (:func:`stack_stage_params`); the outputs (B, ...) the last stage's,
    on every stage of ``mesh``'s ``pipe`` group."""

    def fn(chunks, batch):
        if batch.shape[0] % n_microbatches:
            raise ValueError(
                f"per-shard batch {batch.shape[0]} not divisible by "
                f"n_microbatches={n_microbatches}")
        mb = batch.reshape(n_microbatches, batch.shape[0] // n_microbatches,
                           *batch.shape[1:])
        if len(chunks) == 1:
            out = pipeline_apply(stage_fn, chunks[0], mb, mesh.pipe_group,
                                 remat=remat, wire_dtype=wire_dtype)
        else:
            out = circular_pipeline_apply(stage_fn, chunks, mb,
                                          mesh.pipe_group, remat=remat,
                                          wire_dtype=wire_dtype)
        return out.reshape(batch.shape[0], *out.shape[2:])

    return fn


def stack_stage_params(init_fn: Callable[[torch.Generator], Any],
                       n_stages: int, generator: torch.Generator, mesh, *,
                       n_virtual: int = 1) -> list:
    """This stage's chunks of ``n_stages * n_virtual`` stages
    (``stack_stage_params`` and ``stack_circular_stage_params``,
    ``parallel/pipeline.py:179,309``): every stage is made by
    ``init_fn(generator)`` in execution order on every rank (so all ranks
    draw the same values), and stage ``k = c*n + p`` becomes chunk ``c``
    of the stage at ``pipe`` coordinate ``p``.  JAX stacks them on a
    leading dim sharded over ``pipe``; here each rank keeps its own."""
    stages = [init_fn(generator) for _ in range(n_stages * n_virtual)]
    p = mesh.coords["pipe"]
    return [stages[c * n_stages + p] for c in range(n_virtual)]
