"""Mixture-of-experts: the routers, ``local_moe`` and expert parallelism.

Twin of ``distributedtensorflow_tpu/parallel/moe.py``: ``_capacity_slots``
(``:28``), ``_masked_fracs`` (``:36``), ``top1_route`` (``:49``, Switch),
``top2_route`` (``:81``, GShard), ``expert_choice_route`` (``:126``, Zhou
et al. 2022), ``local_moe`` (``:349``), the path JAX takes when the mesh
has no ``expert`` axis, and the expert-parallel half (``:180-330``):
:func:`expert_parallel_moe`, :func:`make_moe_fn`,
:func:`init_expert_params`, :func:`with_moe_layout` and
:func:`bind_expert_parallel_model`; :func:`local_experts` is the one cut
of an expert stack to a rank's experts.

JAX writes dispatch and combine as one-hot (T, E, C) fp32 tensors and
einsums; at T 16384 tokens, C 5120 slots that is 2.7 GB a tensor.  The
port keeps each assignment as indices instead: a router returns, per
token and choice (T, A), the expert, the 0-based slot in its queue,
whether it kept a slot, and its gate.  :func:`local_moe` copies each kept
token into an (E, C, d) buffer whose other rows are zero, runs the
experts as a batched product, and sums ``gate * out[e, slot]`` per token
in fp32.  The copies are exact and each token has at most A terms, so
the values are those of JAX's einsums (up to where an fp32 sum of two
products rounds).

Over a data-parallel group (a mesh with no ``expert`` axis) JAX's
``local_moe`` sees the global batch: the capacity, every queue position,
and so every drop, and the aux loss's fractions are global.  Each rank
here routes its own tokens, which are one contiguous block of the global
token order (its rows of the microbatch): the ranks gather their per-
expert assignment counts, so a token's global position is its position
on its rank plus the assignments queued ahead of it on the other ranks
(:func:`_global_view`).  Each rank then runs the experts on its own kept
tokens only, in an (E, C, d) buffer with the global capacity C, and
returns its share of the aux loss.

Expert choice inverts the assignment: each expert takes its top-
``capacity`` tokens, so a token is chosen by 0 to E experts.  Its router
(:func:`expert_choice_route`) returns the expert-major (E, C) token
indices and gates; :func:`local_moe` gathers each expert's chosen tokens
into its rows of the (E, C, d) buffer and adds each expert's weighted
outputs into its tokens' rows, expert after expert: a row takes at most
one term an expert, so forward and backward add in a fixed order.  Over
a data-parallel group each expert's top-k is over every rank's tokens,
as in JAX's global jit: the ranks gather the (T, E) fp32 probabilities,
each takes the same global selection and runs its own chosen tokens.

Expert parallelism (:func:`make_moe_fn`, JAX's shard_map region): the
experts' stacks are cut over the ``expert`` axis (rank e holds experts
``[e E/n, (e + 1) E/n)``) and the tokens are a shard over the batch axes
*and* ``expert``: every rank of an ``expert`` group holds the same
tokens (the dense layers around the region stay replicated over
``expert``), and the region takes the rank's 1/n of them
(:func:`..collectives.split_to_group`).  Each rank routes its own token
shard, with the capacity of its local token count and without a gather
(JAX's region sees only its shard), fills the (E, C, d) send buffer,
an all-to-all brings every rank's slots of its own experts, (E/n, n C,
d), the experts run, a second all-to-all sends the outputs back to
(E, C, d), and the rank combines its tokens.  The outputs of the whole
token set are put back together on every rank
(:func:`..collectives.gather_from_group`), every rank computes the same
loss from them, and the router kernel's gradient is summed over the
group (:func:`..collectives.copy_to_group`).  The aux loss is the mean
over ``expert`` of the shards' and, over a data-parallel mesh, each
rank's share of the mean over the batch axes (``:233,289-290``).  As in
JAX, routing depends on the mesh: outputs agree across meshes only when
no token is dropped (``capacity_factor`` = E), and expert choice picks
each shard's top tokens (``:147-152``).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from . import mesh as mesh_lib
from .collectives import (
    all_gather,
    all_to_all,
    copy_to_group,
    gather_from_group,
    group_rank,
    group_size,
    reduce_from_group,
    resolve_group,
    split_to_group,
)


def _capacity_slots(pos: torch.Tensor, mask: torch.Tensor, capacity: int,
                    queue_pos: torch.Tensor | None = None):
    """``(slot, keep)`` for 1-based queue positions ``pos`` and the
    assignment mask ``mask`` (same shape): slot 0-based, clipped to the
    capacity; ``keep`` drops assignments past ``capacity`` and unassigned
    rows (JAX returns the same as a one-hot (T, E, C) dispatch).  With
    ``queue_pos``, the positions in the global queue, ``keep`` reads those
    and the slot stays this rank's ``pos``."""
    keep = ((pos if queue_pos is None else queue_pos) <= capacity) \
        & (mask > 0)
    slot = (pos - 1).clamp(0, capacity - 1)
    return slot, keep


def _masked_fracs(assign: torch.Tensor, probs: torch.Tensor,
                  token_mask: torch.Tensor | None):
    """(frac_tokens, frac_probs) per expert, averaged over real tokens
    only: with padding present, pads must not dilute the aux loss."""
    if token_mask is None:
        return assign.mean(0), probs.mean(0)
    w = token_mask.float()
    denom = w.sum().clamp_min(1.0)
    # assign is already zeroed at pad rows by the caller
    return assign.sum(0) / denom, (probs * w[:, None]).sum(0) / denom


def _global_view(masks, frac_tokens, token_mask, group):
    """What routing the global token set needs beyond this rank's tokens:
    ``(offsets, frac_tokens, share)``.  ``offsets[a]`` (E,) is, per
    expert, the count of assignments that queue ahead of this rank's
    choice-``a`` assignments in the global queue but not in its own (the
    earlier ranks' choice-``a`` ones and the other ranks' earlier
    choices); ``frac_tokens`` the global fraction of first choices;
    ``share`` this rank's weight in a global mean over real tokens (its
    count over the global count).  One gather of per-rank counts."""
    t = masks[0].shape[0]
    # a fill, not a copy from the host: the routing reads nothing on the
    # host and puts nothing on the card but through kernels, so a CUDA
    # graph captures it (capacities come from static token counts)
    count = torch.full((1,), float(t), dtype=masks[0].dtype,
                       device=masks[0].device) if token_mask is None \
        else token_mask.float().sum().reshape(1)
    local = torch.cat([torch.stack([m.sum(0) for m in masks]).flatten(),
                       frac_tokens, count])
    table = all_gather(local.detach(), group, tiled=False)  # (N, ...)
    a, e = len(masks), masks[0].shape[1]
    counts = table[:, :a * e].view(-1, a, e)
    counts_w = table[:, -1]
    shares = counts_w.clamp_min(1.0) / counts_w.sum().clamp_min(1.0)
    frac = (table[:, a * e:-1] * shares[:, None]).sum(0)
    r = group_rank(group)
    before, total, own = counts[:r].sum(0), counts.sum(0), counts[r]
    offsets, earlier = [], torch.zeros_like(frac)
    for c in range(a):
        offsets.append(earlier + before[c])
        earlier = earlier + total[c] - own[c]
    return offsets, frac, shares[r]


def _route(probs, masks, gates, capacity, token_mask, group=None):
    """Queue positions and slots of the choices ``masks`` (A one-hot (T,
    E) fp32 masks, first choices first: each queues behind every earlier
    choice of its expert, GShard's priority rule), stacked to (T, A).
    With a data-parallel ``group`` of more than one rank the queues, the
    drops and the aux loss's token fractions are the global batch's, and
    the aux loss is this rank's share (module docstring)."""
    experts, slots, keeps = [], [], []
    frac_tokens, frac_probs = _masked_fracs(masks[0], probs, token_mask)
    offsets = None
    if group is not None and group_size(group) > 1:
        offsets, frac_tokens, share = _global_view(masks, frac_tokens,
                                                   token_mask, group)
        frac_probs = frac_probs * share
    queued = torch.zeros_like(masks[0][0])  # (E,) assignments ahead
    for i, mask in enumerate(masks):
        # the running count along T as an innermost-dim scan (a scan over
        # the outer dim of a (T, E) tensor runs E threads wide on the card)
        running = mask.t().cumsum(1).t()
        pos = ((running + queued) * mask).sum(1)  # 1-based, 0 if none
        queue_pos = None if offsets is None \
            else pos + (offsets[i] * mask).sum(1)
        slot, keep = _capacity_slots(pos, mask.sum(1), capacity, queue_pos)
        experts.append(mask.argmax(1))
        slots.append(slot.long())
        keeps.append(keep)
        queued = queued + mask.sum(0)
    aux = probs.shape[1] * (frac_tokens * frac_probs).sum()
    return (torch.stack(experts, 1), torch.stack(slots, 1),
            torch.stack(keeps, 1), torch.stack(gates, 1), aux)


def top1_route(logits: torch.Tensor, capacity: int,
               token_mask: torch.Tensor | None = None, group=None):
    """Top-1 routing with capacity (Switch Transformer recipe).

    Returns ``(expert, slot, keep, gate, aux)``: expert, 0-based slot and
    kept flag of each token's one assignment, (T, 1); its gate, the
    router probability, (T, 1) fp32; and the load-balancing loss
    ``E * sum(frac_tokens * frac_probs)``.  ``token_mask`` (T,) 1 = real
    token: pads take no slot and do not dilute the aux loss."""
    probs = torch.softmax(logits.float(), dim=-1)
    onehot = F.one_hot(probs.argmax(-1), probs.shape[1]).float()
    if token_mask is not None:
        onehot = onehot * token_mask.float()[:, None]
    gate = (probs * onehot).sum(-1)
    return _route(probs, [onehot], [gate], capacity, token_mask, group)


def top2_route(logits: torch.Tensor, capacity: int,
               token_mask: torch.Tensor | None = None, group=None):
    """Top-2 routing with capacity (GShard recipe): each token goes to its
    two most probable experts, the two gates renormalised to sum to 1, and
    second choices queue behind every first choice of their expert.  The
    same return contract, (T, 2) per token, and pad handling as
    :func:`top1_route`; the aux loss is over first choices."""
    probs = torch.softmax(logits.float(), dim=-1)
    e = probs.shape[1]
    mask1 = F.one_hot(probs.argmax(-1), e).float()
    mask2 = F.one_hot((probs * (1.0 - mask1)).argmax(-1), e).float()
    if token_mask is not None:
        w = token_mask.float()[:, None]
        mask1, mask2 = mask1 * w, mask2 * w
    g1 = (probs * mask1).sum(-1)
    g2 = (probs * mask2).sum(-1)
    denom = (g1 + g2).clamp_min(1e-9)
    return _route(probs, [mask1, mask2], [g1 / denom, g2 / denom], capacity,
                  token_mask, group)


def expert_choice_route(logits: torch.Tensor, capacity: int,
                        token_mask: torch.Tensor | None = None, group=None):
    """Expert-choice routing: each expert selects its top-``capacity``
    tokens by router probability (``capacity`` at most the token count),
    so every expert is full and ``aux`` is exactly 0.  Pads rank below
    every real token (``probs * w - (1 - w)``) and a pad that still lands
    in a top-k is not kept (``gate > 0``).  Among equal scores the lower
    token index comes first, as ``lax.top_k`` takes it (a stable sort;
    ``torch.topk`` promises no order).

    Returns ``(token, gate, keep, aux)``: the (E, C) global token index,
    fp32 gate (differentiable) and kept flag of each expert's slots.
    Over a data-parallel ``group`` the selection is over every rank's
    tokens (global index = rank-major position); its gates then carry no
    gradient, and :func:`local_moe` takes each kept token's gate from its
    own rank's probabilities.  Not causal: a token's selection reads every
    other token's score."""
    probs = torch.softmax(logits.float(), dim=-1)  # (T, E)
    mask = None if token_mask is None else token_mask.float()
    if group is not None and group_size(group) > 1:
        probs = all_gather(probs.detach(), group)
        if mask is not None:
            mask = all_gather(mask, group)
    capacity = min(capacity, probs.shape[0])
    if mask is not None:
        w = mask[:, None]
        probs = probs * w - (1.0 - w)
    order = torch.sort(probs.t(), dim=1, descending=True, stable=True)
    gate = order.values[:, :capacity]
    return (order.indices[:, :capacity], gate, gate > 0,
            torch.zeros((), dtype=torch.float32, device=logits.device))


ROUTERS = {"top1": top1_route, "top2": top2_route,
           "expert_choice": expert_choice_route}
#: Assignments per token, for capacity scaling (GShard: top-2 needs 2x
#: slots; expert choice's capacity is the EC paper's k = cf * T / E).
_ASSIGNMENTS = {"top1": 1, "top2": 2, "expert_choice": 1}


def capacity_for(tokens: int, n_experts: int, capacity_factor: float,
                 router: str) -> int:
    """Slots per expert: ``capacity_factor`` times the fair share of the
    ``tokens * assignments`` assignments (the GShard 2 * cf * T / E)."""
    return max(1, int(tokens * capacity_factor * _ASSIGNMENTS[router]
                      / n_experts))


def local_moe(tokens: torch.Tensor, router_kernel: torch.Tensor,
              expert_params, expert_fn: Callable, *,
              capacity_factor: float = 1.25, router: str = "top1",
              token_mask: torch.Tensor | None = None, group=None):
    """Single-device MoE: ``(out (T, d) in the tokens' dtype, aux)``.

    ``router_kernel`` (d, E); ``expert_params`` a pytree whose leaves
    lead with E; ``expert_fn(expert_params, x (E, C, d)) -> (E, C, d)``
    runs every expert on its slots (a batched product).  Assignments past
    an expert's capacity contribute 0 (the caller keeps the token on its
    residual path).  ``group``: the data-parallel group (or mesh) whose
    global batch this rank's ``tokens`` belong to, one contiguous block
    of it in rank order; the capacity counts every rank's tokens and aux
    is this rank's share."""
    _check_router(router)
    t, d = tokens.shape
    e = router_kernel.shape[-1]
    capacity = capacity_for(t * (1 if group is None else group_size(group)),
                            e, capacity_factor, router)
    send, combine, aux = _dispatch(tokens, tokens.float()
                                   @ router_kernel.float(), capacity, router,
                                   token_mask, group)
    return combine(expert_fn(expert_params, send)).to(tokens.dtype), aux


def _dispatch(tokens, logits, capacity: int, router: str, token_mask,
              group):
    """``(send, combine, aux)``: the (E, C, d) expert buffer of the
    routed ``tokens`` (rows of dropped or unused slots zero), the function
    that takes the experts' (E, C, d) outputs to the (T, d) fp32
    gate-weighted sum of each token's kept assignments, and the aux
    loss."""
    t, d = tokens.shape
    e = logits.shape[1]
    if router == "expert_choice":
        return _expert_choice_dispatch(tokens, logits, capacity, token_mask,
                                       group)
    expert, slot, keep, gate, aux = ROUTERS[router](logits, capacity,
                                                    token_mask, group)
    # kept assignments land in their (expert, slot) row; dropped ones in a
    # spare last row that is cut off, so nothing needs a host sync
    rows = torch.where(keep, expert * capacity + slot, e * capacity)
    src = tokens.unsqueeze(1).expand(t, rows.shape[1], d)
    send = tokens.new_zeros(e * capacity + 1, d).index_put(
        (rows.reshape(-1),), src.reshape(-1, d))[:-1]

    def combine(out):
        # dropped assignments read row 0 at weight 0.  index_select's
        # backward adds rows with atomics, and row 0 gets only zeros
        # besides its one real term, so the sum does not depend on their
        # order (the backward of advanced indexing would sort and add that
        # repeated row serially)
        picked = out.reshape(e * capacity, d).index_select(
            0, torch.where(keep, rows, 0).reshape(-1)).view(*rows.shape, d)
        weight = torch.where(keep, gate, torch.zeros_like(gate))
        return (picked.float() * weight[..., None]).sum(1)

    return send.view(e, capacity, d), combine, aux


class _Dispatch(torch.autograd.Function):
    """``send[e, c] = tokens[rows[e, c]]`` where ``mine``, else 0: the
    (E, C, d) expert buffer.  The backward adds each expert's rows into
    one fp32 (T, d) gradient, expert after expert, in which a row takes
    at most one nonzero term an expert, so the sum's order is fixed (the
    backward of one gather over all experts would add a token's terms
    with atomics in any order)."""

    @staticmethod
    def forward(ctx, tokens, rows, mine):
        ctx.save_for_backward(rows, mine)
        ctx.shape = tokens.shape
        send = tokens.index_select(0, rows.reshape(-1)).view(
            *rows.shape, tokens.shape[1])
        return torch.where(mine[..., None], send, 0)

    @staticmethod
    def backward(ctx, grad):
        rows, mine = ctx.saved_tensors
        out = grad.new_zeros(ctx.shape, dtype=torch.float32)
        for i in range(rows.shape[0]):
            out.index_add_(0, rows[i],
                           torch.where(mine[i, :, None], grad[i], 0).float())
        return out.to(grad.dtype), None, None


def _expert_choice_dispatch(tokens, logits, capacity, token_mask, group):
    """:func:`_dispatch` for expert choice (module docstring).  Each
    expert's slots hold its kept tokens of this rank (``mine``); any
    other slot reads and adds zeros to a row of its own, so a row takes at
    most one nonzero term an expert and the adds, expert after expert,
    are order-deterministic."""
    t, d = tokens.shape
    token, _, keep, aux = expert_choice_route(logits, capacity, token_mask,
                                              group)
    e, c = token.shape
    # this rank's tokens are rows [offset, offset + t) of the global order
    offset = 0 if group is None else group_rank(group) * t
    mine = keep & (token >= offset) & (token < offset + t)
    spare = torch.arange(c, device=tokens.device).remainder(t).expand(e, c)
    rows = torch.where(mine, token - offset, spare)

    def combine(out):
        # the gate of a kept token is its own router probability (a real
        # token's: pads are never kept), from this rank's differentiable
        # probs
        probs = torch.softmax(logits.float(), dim=-1)
        gate = torch.where(mine, probs.t().gather(1, rows), 0.0)
        combined = torch.zeros(t, d, dtype=torch.float32,
                               device=tokens.device)
        for i in range(e):
            combined.index_add_(0, rows[i], out[i].float() * gate[i, :, None])
        return combined

    return _Dispatch.apply(tokens, rows, mine), combine, aux


# --------------------------------------------------------- expert parallel


def _check_router(router: str) -> None:
    if router not in ROUTERS:
        raise ValueError(f"unknown router {router!r}; expected one of "
                         f"{list(ROUTERS)}")


def expert_parallel_moe(tokens: torch.Tensor, router_kernel: torch.Tensor,
                        expert_params, expert_fn: Callable, group=None, *,
                        capacity_factor: float = 1.25, router: str = "top1",
                        token_mask: torch.Tensor | None = None):
    """The MoE layer on one rank of an ``expert`` ``group`` (JAX's
    region body, ``:180-235``): ``(out (T, d) in the tokens' dtype,
    aux)``.  ``tokens`` (T, d) are this rank's token shard, routed here
    alone with the capacity of its T tokens; ``expert_params`` leaves
    lead with this rank's E/n experts (E = ``router_kernel``'s columns);
    the send buffer (E, C, d) goes through an all-to-all to (E/n, n C, d),
    the experts run on it, and a second all-to-all brings their outputs
    back.  ``aux`` is the mean over the group of the ranks' aux losses,
    each rank's gradient of it 1/n of the mean's (every rank computes the
    same loss from it).  Raises for experts that the group does not
    divide."""
    _check_router(router)
    group = resolve_group(group)
    n = group_size(group)
    t, d = tokens.shape
    e = router_kernel.shape[-1]
    if e % n:
        raise ValueError(f"n_experts={e} not divisible by expert axis size "
                         f"{n}")
    capacity = capacity_for(t, e, capacity_factor, router)
    send, combine, aux = _dispatch(tokens, tokens.float()
                                   @ router_kernel.float(), capacity, router,
                                   token_mask, None)
    # (E, C, d) -> (E/n, n C, d): every rank's slots of this rank's experts
    recv = all_to_all(send, group, split_axis=0, concat_axis=1)
    out = expert_fn(expert_params, recv)
    # (E/n, n C, d) -> (E, C, d): the outputs of this rank's slots
    back = all_to_all(out, group, split_axis=1, concat_axis=0)
    return combine(back).to(tokens.dtype), reduce_from_group(aux, group) / n


def local_experts(stack: torch.Tensor, n: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s experts of ``stack`` (leading dim E) over an
    ``expert`` axis of ``n``: experts ``[rank E/n, (rank + 1) E/n)``, a
    copy; ``stack`` itself for an axis of 1.  Raises for experts that the
    axis does not divide.  The model's stacks
    (``parallel.sharding.shard_expert_stacks``), a JAX checkpoint's
    (``models.convert.shards_for_rank``) and :func:`init_expert_params`
    are all cut here."""
    if n == 1:
        return stack
    if stack.shape[0] % n:
        raise ValueError(f"n_experts={stack.shape[0]} not divisible by "
                         f"expert axis size {n}")
    return stack.chunk(n)[rank].clone()


def init_expert_params(init_one: Callable[[torch.Generator], dict],
                       n_experts: int, generator: torch.Generator,
                       mesh=None) -> dict:
    """Every expert's parameters from ``init_one(generator)`` stacked on a
    leading dim, this rank's E/n of them over ``mesh``'s ``expert`` axis
    (JAX ``init_expert_params``; the experts draw one after another from
    ``generator``, so every rank draws them all and keeps its own)."""
    ones = [init_one(generator) for _ in range(n_experts)]
    stacked = {k: torch.stack([o[k] for o in ones]) for k in ones[0]}
    if mesh is None:
        return stacked
    n, r = mesh.shape[mesh_lib.AXIS_EXPERT], mesh.coords[mesh_lib.AXIS_EXPERT]
    return {k: local_experts(v, n, r) for k, v in stacked.items()}


def make_moe_fn(mesh, expert_fn: Callable, *, capacity_factor: float = 1.25,
                router: str = "top1") -> Callable:
    """The expert-parallel region bound to ``mesh`` (JAX ``make_moe_fn``,
    ``:238-297``): ``fn(tokens (N, d), router_kernel, expert_params,
    token_mask=None) -> (out (N, d), aux)`` with the tokens every rank of
    the ``expert`` group holds, the experts this rank's (leaves (E/n,
    ...)).  The rank routes its 1/n of the tokens
    (:func:`expert_parallel_moe`), every rank gets the whole output, and
    over a data-parallel mesh ``aux`` is the rank's share of the mean over
    the replicas (module docstring)."""
    _check_router(router)
    group = mesh.expert_group
    replicas = mesh_lib.replica_count(mesh)

    def run(tokens, router_kernel, expert_params, token_mask=None):
        n = group_size(group)
        if tokens.shape[0] % n:
            raise ValueError(f"{tokens.shape[0]} tokens do not split over "
                             f"expert={n}")
        out, aux = expert_parallel_moe(
            split_to_group(tokens, group), copy_to_group(router_kernel, group),
            expert_params, expert_fn, group, capacity_factor=capacity_factor,
            router=router, token_mask=None if token_mask is None
            else split_to_group(token_mask, group))
        return gather_from_group(out, group), aux / replicas

    return run


def with_moe_layout(base):
    """``base``'s rules after the expert-parallel ones (JAX
    ``with_moe_layout``, ``:308-321``): the expert stacks over
    ``expert``, the router replicated; the one definition that every MoE
    model's layout shares."""
    from .sharding import LayoutMap, P

    rules = LayoutMap([
        (r".*moe_mlp/experts_in", P("expert", None, None)),
        (r".*moe_mlp/experts_out", P("expert", None, None)),
        (r".*moe_mlp/router", P()),
    ])
    rules._rules.extend(base._rules)
    return rules


def bind_expert_parallel_model(cfg, mesh, model_ctor, expert_fn, **kw):
    """``model_ctor(cfg, moe_fn=..., **kw)`` with the all-to-all region
    (:func:`make_moe_fn`) when ``mesh`` has an ``expert`` axis larger than
    1, else ``model_ctor(cfg, moe_fn=None, **kw)``, the local experts
    (JAX ``bind_expert_parallel_model``, ``:324-335``); the one bind that
    every MoE model family uses."""
    moe_fn = None
    if mesh is not None and mesh.shape[mesh_lib.AXIS_EXPERT] > 1:
        moe_fn = make_moe_fn(mesh, expert_fn,
                             capacity_factor=cfg.capacity_factor,
                             router=cfg.router)
    return model_ctor(cfg, moe_fn=moe_fn, **kw)
