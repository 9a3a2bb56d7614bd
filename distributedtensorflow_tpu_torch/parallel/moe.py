"""Mixture-of-experts on one device: the routers and ``local_moe``.

Twin of the local half of ``distributedtensorflow_tpu/parallel/moe.py``:
``_capacity_slots`` (``:28``), ``_masked_fracs`` (``:36``), ``top1_route``
(``:49``, Switch), ``top2_route`` (``:81``, GShard) and ``local_moe``
(``:349``), the path JAX takes when the mesh has no ``expert`` axis.
Expert parallelism (``expert_parallel_moe``, ``make_moe_fn``) and the
``expert_choice`` router are not ported yet.

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
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from .collectives import all_gather, group_rank, group_size


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
    count = masks[0].new_tensor([float(t)]) if token_mask is None \
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


ROUTERS = {"top1": top1_route, "top2": top2_route}
#: Assignments per token, for capacity scaling (GShard: top-2 needs 2x
#: slots).
_ASSIGNMENTS = {"top1": 1, "top2": 2}


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
    if router not in ROUTERS:
        raise ValueError(f"unknown router {router!r}; the port has "
                         f"{list(ROUTERS)}")
    t, d = tokens.shape
    e = router_kernel.shape[-1]
    capacity = capacity_for(t * (1 if group is None else group_size(group)),
                            e, capacity_factor, router)
    logits = tokens.float() @ router_kernel.float()
    expert, slot, keep, gate, aux = ROUTERS[router](logits, capacity,
                                                    token_mask, group)
    # kept assignments land in their (expert, slot) row; dropped ones in a
    # spare last row that is cut off, so nothing needs a host sync
    rows = torch.where(keep, expert * capacity + slot, e * capacity)
    src = tokens.unsqueeze(1).expand(t, rows.shape[1], d)
    send = tokens.new_zeros(e * capacity + 1, d).index_put(
        (rows.reshape(-1),), src.reshape(-1, d))[:-1]
    out = expert_fn(expert_params, send.view(e, capacity, d))
    # dropped assignments read row 0 at weight 0.  index_select's backward
    # adds rows with atomics, and row 0 gets only zeros besides its one
    # real term, so the sum does not depend on their order (the backward
    # of advanced indexing would sort and add that repeated row serially)
    picked = out.reshape(e * capacity, d).index_select(
        0, torch.where(keep, rows, 0).reshape(-1)).view(*rows.shape, d)
    weight = torch.where(keep, gate, torch.zeros_like(gate))
    combined = (picked.float() * weight[..., None]).sum(1)
    return combined.to(tokens.dtype), aux
