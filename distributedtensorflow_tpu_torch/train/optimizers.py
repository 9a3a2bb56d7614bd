"""Optimizers and learning-rate schedules of the port.

Twin of ``distributedtensorflow_tpu/train/optimizers.py``: the presets'
optimizers (:func:`adamw`, a ``torch.optim.AdamW``; :func:`sgd` and
:func:`adagrad`, ``optax.sgd`` and ``optax.adagrad``, with
:func:`warmup_cosine_decay_schedule`) and the factory behind
``train_torch.py --optimizer/--lr/--schedule`` (:func:`build_schedule`,
:func:`build_optimizer`, :func:`exclude_bias_and_norm_mask`), with the
JAX module's names, choices and validation (``:14-167``).

Each optimizer matches its optax twin update for update: sgd and
nesterov momentum are ``torch.optim.SGD``, adam and adamw the one
AdamW (adam without decay), adagrad is written out (:class:`Adagrad`)
because torch's starts its accumulator and places eps elsewhere.  A
step pre-hook adds optax's chain head to each: the learning rate of
optax's count (the first update uses ``lr(0)``) and
``clip_by_global_norm``.  The count lives in the optimizer's parameter
groups (``"count"``), so ``state_dict()`` saves it and
``load_state_dict()`` restores it: a resumed optimizer goes on with the
schedule where the saved one stopped.  lamb, lars, adafactor and lion are queued in
ROADMAP.md and raise.

Parameters are passed as an iterable of tensors or of ``(name,
tensor)`` pairs (``model.named_parameters()``); a weight-decay mask needs
the names.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

OPTIMIZERS = ("sgd", "momentum", "adam", "adamw", "lamb", "lars",
              "adagrad", "adafactor", "lion")
SCHEDULES = ("constant", "cosine", "linear")
#: Optimizers whose optax builder takes decoupled weight decay.
_DECAY_CAPABLE = ("adamw", "lamb", "lars", "lion")
#: Optimizers of the JAX package that the port does not have yet.
_NOT_PORTED = ("lamb", "lars", "adafactor", "lion")

Schedule = Callable[[int], float]


def _split_named(params) -> tuple[list[str] | None, list[torch.Tensor]]:
    items = list(params)
    if items and isinstance(items[0], tuple):
        names, tensors = zip(*items)
        return list(names), list(tensors)
    return None, items


def _resolve_mask(mask, names, tensors) -> list[bool]:
    """Per-parameter decay flags from ``mask``: a callable of the named
    parameters or a dict, both name -> bool (True = decay)."""
    if names is None:
        raise ValueError("a weight-decay mask needs named parameters "
                         "(model.named_parameters())")
    flags = mask(list(zip(names, tensors))) if callable(mask) else mask
    missing = set(names) - set(flags)
    if missing:
        raise ValueError(f"decay mask has no entry for {sorted(missing)}")
    return [bool(flags[n]) for n in names]


def adamw(params, learning_rate: float = 3e-4, *, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 1e-4,
          mask=None) -> torch.optim.Optimizer:
    """``optax.adamw`` as a ``torch.optim.AdamW``.

    The two compute the same update: bias-corrected moments, ``eps``
    added outside the square root, and decoupled decay ``lr * wd * p``
    on the parameters before the step (optax adds it to the update; torch
    scales the parameters first, which gives the same values because
    the Adam term does not read them).  optax's defaults: ``weight_decay
    1e-4``, decay on every parameter (``mask=None``); ``mask`` (see
    :func:`exclude_bias_and_norm_mask`) puts the parameters it leaves out
    in a group without decay."""
    names, tensors = _split_named(params)
    groups = [{"params": tensors}]
    if mask is not None:
        flags = _resolve_mask(mask, names, tensors)
        groups = [{"params": [p for p, f in zip(tensors, flags) if f]},
                  {"params": [p for p, f in zip(tensors, flags) if not f],
                   "weight_decay": 0.0}]
    return torch.optim.AdamW(groups, lr=learning_rate, betas=(b1, b2),
                             eps=eps, weight_decay=weight_decay)


# ------------------------------------------------------------------ schedules


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """``optax.linear_schedule``: from ``init_value`` at count 0 to
    ``end_value`` at ``transition_steps``, held there after."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count):
        frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    """``optax.cosine_decay_schedule``."""
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}.")

    def schedule(count):
        count = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def join_schedules(schedules: list[Schedule],
                   boundaries: list[int]) -> Schedule:
    """``optax.join_schedules``: each schedule counts from its boundary."""

    def schedule(count):
        out = schedules[0](count)
        for boundary, fn in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = fn(count - boundary)
        return out

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps``, then a cosine to
    ``end_value`` at ``decay_steps`` (counted from 0, warmup included)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return join_schedules(
        [linear_schedule(init_value, peak_value, warmup_steps),
         cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)],
        [warmup_steps])


def build_schedule(name: str, lr: float, *, warmup_steps: int = 0,
                   total_steps: int = 0) -> Schedule | float:
    """LR schedule: constant | cosine | linear (each with optional linear
    warmup from 0).  Decay schedules need ``total_steps``."""
    if name not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, got {name!r}")
    if name == "constant":
        if warmup_steps:
            return linear_schedule(0.0, lr, warmup_steps)
        return lr
    if not total_steps:
        raise ValueError(f"schedule {name!r} needs total_steps > 0")
    if warmup_steps >= total_steps:
        raise ValueError(
            f"warmup_steps={warmup_steps} must be < total_steps="
            f"{total_steps} for schedule {name!r} (nothing left to decay)")
    if name == "cosine":
        if not warmup_steps:
            return cosine_decay_schedule(lr, total_steps)
        return join_schedules(
            [linear_schedule(0.0, lr, warmup_steps),
             cosine_decay_schedule(lr, total_steps - warmup_steps)],
            [warmup_steps])
    if not warmup_steps:
        return linear_schedule(lr, 0.0, total_steps)
    return join_schedules(
        [linear_schedule(0.0, lr, warmup_steps),
         linear_schedule(lr, 0.0, total_steps - warmup_steps)],
        [warmup_steps])


# ----------------------------------------------------------------- optimizers


def exclude_bias_and_norm_mask(named_params) -> dict[str, bool]:
    """Weight-decay mask, True = decay: a parameter whose last name part
    is ``bias`` or ``scale``, or of rank <= 1, carries no decay (the JAX
    rule, ``:72-100``, over the port's parameter names)."""
    return {name: p.dim() > 1 and name.rsplit(".", 1)[-1] not in
            ("bias", "scale") for name, p in named_params}


@torch.no_grad()
def _clip_by_global_norm(grads: list[torch.Tensor], clipnorm: float) -> None:
    """``optax.clip_by_global_norm`` in place: each gradient becomes
    ``g / norm * clipnorm`` when the global norm reaches ``clipnorm``,
    chosen on the device (no host sync)."""
    g_norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    for g in grads:
        norm = g_norm.to(g.dtype)
        g.copy_(torch.where(norm < clipnorm, g, g / norm * clipnorm))


def _optax_prelude(lr, clipnorm: float):
    """A step pre-hook that gives a torch optimizer optax's chain head:
    the learning rate of optax's count (the first update uses ``lr(0)``)
    and, for ``clipnorm > 0``, clipping by the global norm.  The count
    of updates so far is ``"count"`` in every parameter group, state that
    ``state_dict()`` carries."""

    def hook(opt, args, kwargs):
        count = opt.param_groups[0].get("count", 0)
        for group in opt.param_groups:
            group["lr"] = lr(count) if callable(lr) else lr
            group["count"] = count + 1
        if clipnorm:
            _clip_by_global_norm([p.grad for group in opt.param_groups
                                  for p in group["params"]
                                  if p.grad is not None], clipnorm)

    return hook


class Adagrad(torch.optim.Optimizer):
    """``optax.adagrad``: the accumulator starts at 0.1 and ``eps`` 1e-7
    sits inside the root, where ``torch.optim.Adagrad`` differs."""

    def __init__(self, params, lr: float):
        super().__init__(params, {"lr": lr})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g, st = p.grad, self.state[p]
                sos = g * g + st.get("sos", torch.full_like(p, 0.1))
                st["sos"] = sos
                u = torch.where(sos > 0, torch.rsqrt(sos + 1e-7), 0.0) * g
                p.add_(u, alpha=-group["lr"])


def sgd(params, learning_rate: float | Schedule, *,
        momentum: float | None = None, nesterov: bool = False,
        global_clipnorm: float = 0.0) -> torch.optim.Optimizer:
    """``optax.sgd``: ``torch.optim.SGD`` (optax's trace is torch's
    momentum buffer, ``g + momentum * buf``) behind optax's chain head
    (:func:`_optax_prelude`: the learning rate of optax's count when
    ``learning_rate`` is a schedule, clipping for ``global_clipnorm``)."""
    lr0 = learning_rate(0) if callable(learning_rate) else learning_rate
    opt = torch.optim.SGD(_split_named(params)[1], lr=lr0,
                          momentum=momentum or 0.0, nesterov=nesterov)
    opt.register_step_pre_hook(_optax_prelude(learning_rate, global_clipnorm))
    return opt


def adagrad(params, learning_rate: float | Schedule, *,
            global_clipnorm: float = 0.0) -> torch.optim.Optimizer:
    """``optax.adagrad`` (:class:`Adagrad`) behind optax's chain head."""
    lr0 = learning_rate(0) if callable(learning_rate) else learning_rate
    opt = Adagrad(_split_named(params)[1], lr0)
    opt.register_step_pre_hook(_optax_prelude(learning_rate, global_clipnorm))
    return opt


def build_optimizer(name: str, lr: float | Schedule, *,
                    weight_decay: float = 0.0, momentum: float = 0.9,
                    global_clipnorm: float = 0.0, decay_mask=None,
                    ) -> Callable[..., torch.optim.Optimizer]:
    """The --optimizer CLI surface: ``params -> optimizer`` for ``name``.

    Same validation as the JAX builder: ``weight_decay`` is refused for
    optimizers without decoupled decay, ``global_clipnorm`` must be >= 0
    (0 disables it), ``decay_mask`` (:func:`exclude_bias_and_norm_mask`
    or a name -> bool dict) is for adamw/lamb/lion."""
    if weight_decay and name not in _DECAY_CAPABLE:
        raise ValueError(
            f"optimizer {name!r} has no decoupled weight decay "
            f"(supported: {_DECAY_CAPABLE}); use the loss-side L2 instead")
    if global_clipnorm < 0:
        raise ValueError(f"global_clipnorm must be >= 0 (0 disables "
                         f"clipping), got {global_clipnorm}")
    if decay_mask is not None and name not in ("adamw", "lamb", "lion"):
        raise ValueError(
            f"decay_mask is supported for adamw/lamb/lion, not {name!r}")
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (queued in ROADMAP.md)")
    if name not in OPTIMIZERS:
        raise ValueError(
            f"optimizer must be one of {OPTIMIZERS}, got {name!r}")

    def make(params) -> torch.optim.Optimizer:
        params = list(params)
        if name == "adagrad":
            return adagrad(params, lr, global_clipnorm=global_clipnorm)
        if name in ("sgd", "momentum"):
            nesterov = name == "momentum"
            return sgd(params, lr, momentum=momentum if nesterov else None,
                       nesterov=nesterov, global_clipnorm=global_clipnorm)
        opt = adamw(params, lr(0) if callable(lr) else lr,
                    weight_decay=weight_decay, mask=decay_mask)
        opt.register_step_pre_hook(_optax_prelude(lr, global_clipnorm))
        return opt

    return make
