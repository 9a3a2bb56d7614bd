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
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def _capacity_slots(pos: torch.Tensor, mask: torch.Tensor, capacity: int):
    """``(slot, keep)`` for 1-based queue positions ``pos`` and the
    assignment mask ``mask`` (same shape): slot 0-based, clipped to the
    capacity; ``keep`` drops assignments past ``capacity`` and unassigned
    rows (JAX returns the same as a one-hot (T, E, C) dispatch)."""
    keep = (pos <= capacity) & (mask > 0)
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


def _route(probs, masks, gates, capacity, token_mask):
    """Queue positions and slots of the choices ``masks`` (A one-hot (T,
    E) fp32 masks, first choices first: each queues behind every earlier
    choice of its expert, GShard's priority rule), stacked to (T, A)."""
    experts, slots, keeps = [], [], []
    queued = torch.zeros_like(masks[0][0])  # (E,) assignments ahead
    for mask in masks:
        # the running count along T as an innermost-dim scan (a scan over
        # the outer dim of a (T, E) tensor runs E threads wide on the card)
        running = mask.t().cumsum(1).t()
        pos = ((running + queued) * mask).sum(1)  # 1-based, 0 if none
        slot, keep = _capacity_slots(pos, mask.sum(1), capacity)
        experts.append(mask.argmax(1))
        slots.append(slot.long())
        keeps.append(keep)
        queued = queued + mask.sum(0)
    frac_tokens, frac_probs = _masked_fracs(masks[0], probs, token_mask)
    aux = probs.shape[1] * (frac_tokens * frac_probs).sum()
    return (torch.stack(experts, 1), torch.stack(slots, 1),
            torch.stack(keeps, 1), torch.stack(gates, 1), aux)


def top1_route(logits: torch.Tensor, capacity: int,
               token_mask: torch.Tensor | None = None):
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
    return _route(probs, [onehot], [gate], capacity, token_mask)


def top2_route(logits: torch.Tensor, capacity: int,
               token_mask: torch.Tensor | None = None):
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
                  token_mask)


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
              token_mask: torch.Tensor | None = None):
    """Single-device MoE: ``(out (T, d) in the tokens' dtype, aux)``.

    ``router_kernel`` (d, E); ``expert_params`` a pytree whose leaves
    lead with E; ``expert_fn(expert_params, x (E, C, d)) -> (E, C, d)``
    runs every expert on its slots (a batched product).  Assignments past
    an expert's capacity contribute 0 (the caller keeps the token on its
    residual path)."""
    if router not in ROUTERS:
        raise ValueError(f"unknown router {router!r}; the port has "
                         f"{list(ROUTERS)}")
    t, d = tokens.shape
    e = router_kernel.shape[-1]
    capacity = capacity_for(t, e, capacity_factor, router)
    logits = tokens.float() @ router_kernel.float()
    expert, slot, keep, gate, aux = ROUTERS[router](logits, capacity,
                                                    token_mask)
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
