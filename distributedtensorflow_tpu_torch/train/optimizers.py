"""Optimizers and learning-rate schedules of the port.

Twin of ``distributedtensorflow_tpu/train/optimizers.py``: the presets'
optimizers (:func:`adamw`, a ``torch.optim.AdamW``; :func:`sgd` and
:func:`adagrad`, ``optax.sgd`` and ``optax.adagrad``, with
:func:`warmup_cosine_decay_schedule`) and the factory behind
``train_torch.py --optimizer/--lr/--schedule`` (:func:`build_schedule`,
:func:`build_optimizer`, :func:`exclude_bias_and_norm_mask`), with the
JAX module's names, choices and validation (``:14-167``).

Each optimizer matches its optax twin update for update: adam and adamw
are the one AdamW (adam without decay); sgd and nesterov momentum
(:class:`SGD`) and adagrad (:class:`Adagrad`) are written out, because
torch's SGD reads a tensor learning rate on the host and torch's Adagrad
starts its accumulator and places eps elsewhere; :class:`Lamb`,
:class:`Lars`, :class:`Adafactor` and :class:`Lion` are optax's chains
(``:149-167`` of the JAX module) written out, their trust ratios, block
rms and factored moments per parameter on the device.  A step pre-hook
adds optax's chain head to each: the learning rate of optax's count (the
first update uses ``lr(0)``) and ``clip_by_global_norm``.  The count lives
in the optimizer's parameter groups (``"count"``), so ``state_dict()``
saves it and ``load_state_dict()`` restores it: a resumed optimizer goes
on with the schedule where the saved one stopped.

On the card every update can be captured in a CUDA graph
(``train.engine.make_multi_train_step``): a schedule's learning rate is
a slot of a device table (:class:`RateTable`, the optimizer's ``rates``)
that the update reads, which the pre-hook fills with ``lr(count)`` before
an eager update and the host fills with the next k rates before a
replay (a constant rate stays a Python float: the graph holds it as it
is); AdamW is ``capturable`` (its step counts on the device), and
clipping chooses on the device; LAMB and Adafactor count their updates on
the device too (``"step"``, read by the bias corrections and the decay
rate), and every ``where(norm == 0, ...)`` guard is a device select.
Outside an update the groups' ``"lr"``
is the Python float of the last update, as on the CPU, where the rates
stay floats.  An eager update and a replayed one run the same code.

Parameters are passed as an iterable of tensors or of ``(name,
tensor)`` pairs (``model.named_parameters()``); a weight-decay mask needs
the names.  An optimizer over pieces of parameters (ZeRO's rows, the
shards of a model split over ``model``, ``expert`` or ``pipe``) carries a
:class:`Split` (``opt.split``): the clip then takes the norm of the
logical whole gradients, and LAMB's and LARS's trust ratios the norms of
whole parameters.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable

import torch

OPTIMIZERS = ("sgd", "momentum", "adam", "adamw", "lamb", "lars",
              "adagrad", "adafactor", "lion")
SCHEDULES = ("constant", "cosine", "linear")
#: Optimizers whose optax builder takes decoupled weight decay.
_DECAY_CAPABLE = ("adamw", "lamb", "lars", "lion")

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


def _decay_groups(params, weight_decay: float, mask) -> list[dict]:
    """One parameter group, or with a decay ``mask`` two: the masked-out
    parameters in a group of their own without decay."""
    names, tensors = _split_named(params)
    if mask is None:
        return [{"params": tensors, "weight_decay": weight_decay}]
    flags = _resolve_mask(mask, names, tensors)
    return [{"params": [p for p, f in zip(tensors, flags) if f],
             "weight_decay": weight_decay},
            {"params": [p for p, f in zip(tensors, flags) if not f],
             "weight_decay": 0.0}]


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
    in a group without decay.  On the card it is ``capturable`` (the
    step counts and bias corrections on the device) and reads its
    learning rate from a :class:`RateTable`."""
    groups = _decay_groups(params, weight_decay, mask)
    cuda = _on_cuda(groups)
    opt = torch.optim.AdamW(groups, lr=learning_rate, betas=(b1, b2),
                            eps=eps, weight_decay=weight_decay,
                            capturable=cuda)
    # an eager step of a capturable optimizer warns once; the port runs
    # the same update eagerly and under capture on purpose
    opt._warned_capturable_if_run_uncaptured = True
    return opt


class RateTable:
    """The learning rates of an optimizer on the card, in device memory
    where its update reads them (fp32 slots).  An eager update takes slot
    0, filled by a kernel with the host's rate; inside :meth:`capturing`
    the i-th update of the capture reads slot i, which the caller fills
    (:meth:`fill`) before each replay."""

    def __init__(self, device, size: int = 1):
        self.table = torch.zeros(size, dtype=torch.float32, device=device)
        self._next: int | None = None

    def reserve(self, size: int) -> None:
        """At least ``size`` slots; only before a capture reads them."""
        if self.table.numel() < size:
            self.table = torch.zeros(size, dtype=torch.float32,
                                     device=self.table.device)

    def slot(self, rate: float) -> torch.Tensor:
        if self._next is None:
            out = self.table[0]
            out.fill_(rate)
            return out
        out = self.table[self._next]
        self._next += 1
        return out

    @contextlib.contextmanager
    def capturing(self):
        """The updates inside take slots 0, 1, ... in turn and write none
        of them."""
        self._next = 0
        try:
            yield
        finally:
            self._next = None

    def fill(self, rates) -> None:
        """Slots 0..len(rates)-1 from host floats, one copy from pinned
        memory without a host sync (a fresh pinned block per call, so a
        copy still queued is never overwritten)."""
        host = torch.tensor(list(rates), dtype=torch.float32).pin_memory()
        self.table[:len(rates)].copy_(host, non_blocking=True)


def _on_cuda(groups) -> bool:
    tensors = [p for g in groups for p in g["params"]]
    return bool(tensors) and tensors[0].is_cuda


def _descend(p: torch.Tensor, update: torch.Tensor, lr) -> None:
    """``p -= lr * update`` for a float ``lr`` or a one-element tensor on
    ``p``'s device (read there, never on the host)."""
    if torch.is_tensor(lr):
        p.addcmul_(update, lr, value=-1.0)
    else:
        p.add_(update, alpha=-lr)


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


@dataclasses.dataclass
class Split:
    """Where the pieces of an optimizer's parameters live over a mesh
    (``parallel.placement.Placement.bind`` and ``parallel.zero.
    ZeroSharder.shard_optimizer`` set it as the optimizer's ``split``):
    ``groups`` the kinds of group that split some parameter,
    ``(kind, group, this rank's index in it)``, in one order on every
    rank; ``norm[id(p)]`` the kinds whose ranks hold disjoint pieces of
    ``p`` (the global norm sums its squares over them and counts it once
    over the others); ``stats[id(p)]`` the groups over which a
    layer-wise statistic of ``p`` (a trust ratio's norms) is summed."""

    groups: list
    norm: dict
    stats: dict
    #: per device, each group's 0/1 vector over the classes (made once,
    #: outside any CUDA-graph capture: the first update is eager)
    _keep: dict = dataclasses.field(default_factory=dict)

    def keep(self, device) -> list[torch.Tensor]:
        if device not in self._keep:
            n = 1 << len(self.groups)
            self._keep[device] = [
                torch.tensor([1.0 if (b >> i) & 1 or rank == 0 else 0.0
                              for b in range(n)], device=device)
                for i, (_, _, rank) in enumerate(self.groups)]
        return self._keep[device]


def _split_square_sum(grads, kinds, split: Split) -> torch.Tensor:
    """The squares of the logical whole gradients, each element once:
    per class of parameters (the kinds their pieces are split over, a bit
    each, so every rank holds the same vector) the local sum, then over
    each group in turn the sum of the classes split over it and rank 0's
    value of the others (which every rank of the group holds alike)."""
    order = [k for k, _, _ in split.groups]
    sums: dict[int, torch.Tensor] = {}
    for g, ks in zip(grads, kinds):
        bits = sum(1 << order.index(k) for k in ks)
        sq = g.float().square().sum()
        sums[bits] = sq if bits not in sums else sums[bits] + sq
    device = grads[0].device
    vec = torch.stack([sums.get(b, torch.zeros((), device=device))
                       for b in range(1 << len(order))])
    for (_, group, _), keep in zip(split.groups, split.keep(device)):
        vec = _all_reduce(vec * keep, group)
    return vec.sum()


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` (a new tensor)."""
    from ..parallel.collectives import all_reduce

    return all_reduce(t, group)


@torch.no_grad()
def _clip_by_global_norm(grads: list[torch.Tensor], clipnorm: float,
                         kinds=None, split=None) -> None:
    """``optax.clip_by_global_norm`` in place: each gradient becomes
    ``g / norm * clipnorm`` when the global norm reaches ``clipnorm``,
    chosen on the device (no host sync).  Over parameters held in pieces
    (``split``, with each gradient's ``kinds``: ZeRO's rows, the shards
    of a split model) the norm is the logical whole's
    (:func:`_split_square_sum`), the same on every rank."""
    if split is not None:
        g_norm = torch.sqrt(_split_square_sum(grads, kinds, split))
    else:
        g_norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    for g in grads:
        norm = g_norm.to(g.dtype)
        g.copy_(torch.where(norm < clipnorm, g, g / norm * clipnorm))


def learning_rate(lr, count: int) -> float:
    """The rate of update ``count`` (from 0) of a schedule or constant."""
    return lr(count) if callable(lr) else lr


def _optax_prelude(opt, lr, clipnorm: float):
    """Give a torch optimizer optax's chain head, as a step pre-hook and a
    post-hook: the learning rate of optax's count (the first update uses
    ``lr(0)``) and, for ``clipnorm > 0``, clipping by the global norm.
    The count of updates so far is ``"count"`` in every parameter group,
    state that ``state_dict()`` carries.  On the card a schedule's update
    reads its rate from ``opt.rates`` (a :class:`RateTable`), and each
    group's ``"lr"`` is the host float again afterwards; a constant rate
    stays a float, which a CUDA graph may hold as it is."""
    params = [p for group in opt.param_groups for p in group["params"]]
    opt.rates = RateTable(params[0].device) \
        if callable(lr) and params and params[0].is_cuda else None

    def pre(opt, args, kwargs):
        count = opt.param_groups[0].get("count", 0)
        rate = learning_rate(lr, count)
        value = rate if opt.rates is None else opt.rates.slot(rate)
        for group in opt.param_groups:
            group["lr"] = value
            group["count"] = count + 1
        if clipnorm:
            params = [p for group in opt.param_groups
                      for p in group["params"] if p.grad is not None]
            split = getattr(opt, "split", None)
            _clip_by_global_norm(
                [p.grad for p in params], clipnorm,
                kinds=split and [split.norm[id(p)] for p in params],
                split=split)

    def post(opt, args, kwargs):
        rate = learning_rate(lr, opt.param_groups[0]["count"] - 1)
        for group in opt.param_groups:
            group["lr"] = rate

    opt.register_step_pre_hook(pre)
    opt.register_step_post_hook(post)
    opt.schedule = lr
    return opt


def schedule_rates(opt, k: int) -> list[float] | None:
    """The learning rates of ``opt``'s next ``k`` updates (optax's counts
    ``count .. count + k - 1``), or None for an optimizer without optax's
    chain head (its rate is a constant of its groups)."""
    lr = getattr(opt, "schedule", None)
    if lr is None:
        return None
    count = opt.param_groups[0].get("count", 0)
    return [learning_rate(lr, count + i) for i in range(k)]


def advance_schedule(opt, k: int) -> None:
    """What ``k`` pre- and post-hooks would leave: the count ``k`` further
    and each group's ``"lr"`` the rate of the last of those updates (a
    replayed graph ran the updates without the hooks)."""
    lr = getattr(opt, "schedule", None)
    if lr is None:
        return
    count = opt.param_groups[0].get("count", 0) + k
    for group in opt.param_groups:
        group["count"] = count
        group["lr"] = learning_rate(lr, count - 1)


class SGD(torch.optim.Optimizer):
    """``optax.sgd``: optax's trace is ``g + momentum * trace`` (torch's
    momentum buffer, the first one ``g``), nesterov adds ``momentum *
    trace`` to ``g`` once more, and the parameters move by ``-lr`` times
    that.  Written out because torch's SGD reads a tensor learning rate
    on the host; the state keeps torch's ``momentum_buffer``."""

    def __init__(self, params, lr, momentum: float = 0.0,
                 nesterov: bool = False):
        super().__init__(params, {"lr": lr, "momentum": momentum,
                                  "nesterov": nesterov})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            mu = group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if mu:
                    st = self.state[p]
                    buf = st.get("momentum_buffer")
                    if buf is None:
                        buf = st["momentum_buffer"] = g.clone()
                    else:
                        buf.mul_(mu).add_(g)
                    g = g.add(buf, alpha=mu) if group["nesterov"] else buf
                _descend(p, g, group["lr"])


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
                if "sos" not in st:
                    st["sos"] = torch.full_like(p, 0.1)
                sos = st["sos"].addcmul_(g, g)
                u = torch.where(sos > 0, torch.rsqrt(sos + 1e-7), 0.0) * g
                _descend(p, u, group["lr"])


def _count(opt, p: torch.Tensor, group) -> torch.Tensor:
    """The parameter's update count after this update (optax's
    ``safe_increment`` of its count), a 0-d fp32 tensor that lives on the
    device when the optimizer is ``capturable``, so a CUDA graph advances
    it."""
    st = opt.state[p]
    if "step" not in st:
        st["step"] = torch.zeros((), dtype=torch.float32,
                                 device=p.device if group["capturable"]
                                 else "cpu")
    return st["step"].add_(1)


def _power(base: float, count: torch.Tensor) -> torch.Tensor:
    """``base ** count`` as optax's fp32 power of the fp32 ``base``,
    rounded once: taken in fp64, since the card's fp32 power is an ulp
    or two off, which ``1 - b2 ** t`` magnifies a thousandfold."""
    base32 = float(torch.tensor(base, dtype=torch.float32))
    return torch.pow(base32, count.double()).float()


def _trust_ratio(param: torch.Tensor, update: torch.Tensor,
                 coefficient: float = 1.0, groups=()) -> torch.Tensor:
    """``optax.scale_by_trust_ratio``'s factor: ``coefficient * |param| /
    |update|``, or 1 where either norm is 0, chosen on the device.  The
    norms accumulate in fp64: the CPU's fp32 ``vector_norm`` of a
    23M-element table (BERT's MLM head) is 1.3e-3 off.  ``groups``: the
    ranks that hold the other pieces of a split parameter (and of its
    update), over which the two squared norms are summed: the whole
    array's norms, as optax's under GSPMD."""
    p_norm = torch.linalg.vector_norm(param, dtype=torch.float64)
    u_norm = torch.linalg.vector_norm(update, dtype=torch.float64)
    if groups:
        sq = torch.stack([p_norm, u_norm]).square()
        for group in groups:
            sq = _all_reduce(sq, group)
        p_norm, u_norm = sq.sqrt().unbind(0)
    p_norm, u_norm = p_norm.float(), u_norm.float()
    ratio = coefficient * p_norm / u_norm
    return torch.where((p_norm == 0) | (u_norm == 0),
                       torch.ones_like(ratio), ratio)


def _stat_groups(opt, p) -> tuple:
    """The groups over which ``p``'s layer-wise statistics are summed
    (none without a ``split``)."""
    split = getattr(opt, "split", None)
    return () if split is None else split.stats.get(id(p), ())


class Lamb(torch.optim.Optimizer):
    """``optax.lamb``: ``scale_by_adam`` (eps 1e-6 outside the root), then
    ``add_decayed_weights`` (``weight_decay`` of the parameter's group),
    ``scale_by_trust_ratio`` per parameter and the learning rate.  The
    moments are AdamW's ``exp_avg``/``exp_avg_sq``; the bias corrections
    read the update count ``"step"``."""

    def __init__(self, params, lr, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-6, weight_decay: float = 0.0,
                 capturable: bool = False):
        super().__init__(params, {"lr": lr, "b1": b1, "b2": b2, "eps": eps,
                                  "weight_decay": weight_decay,
                                  "capturable": capturable})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2, wd = group["b1"], group["b2"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g, st = p.grad, self.state[p]
                count = _count(self, p, group)
                if "exp_avg" not in st:
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                mu = st["exp_avg"].mul_(b1).add_(g, alpha=1 - b1)
                nu = st["exp_avg_sq"].mul_(b2).add_(g.square(),
                                                    alpha=1 - b2)
                u = (mu / (1 - _power(b1, count))) \
                    / ((nu / (1 - _power(b2, count))).sqrt() + group["eps"])
                if wd:
                    u = u + wd * p
                _descend(p, u * _trust_ratio(p, u, 1.0,
                                             _stat_groups(self, p)),
                         group["lr"])


class Lars(torch.optim.Optimizer):
    """``optax.lars``: ``add_decayed_weights``, the trust ratio with
    ``trust_coefficient`` 0.001, the learning rate, then the momentum
    ``trace`` (torch's ``momentum_buffer``): the trace comes after the
    learning rate, so a schedule's rate sits inside the buffer and the
    parameters move by the trace itself."""

    def __init__(self, params, lr, weight_decay: float = 0.0,
                 momentum: float = 0.9, trust_coefficient: float = 0.001,
                 capturable: bool = False):
        super().__init__(params, {"lr": lr, "weight_decay": weight_decay,
                                  "momentum": momentum,
                                  "trust_coefficient": trust_coefficient,
                                  "capturable": capturable})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            wd = group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                u, st = p.grad, self.state[p]
                if wd:
                    u = u + wd * p
                u = u * _trust_ratio(p, u, group["trust_coefficient"],
                                     _stat_groups(self, p))
                if "momentum_buffer" not in st:
                    st["momentum_buffer"] = torch.zeros_like(p)
                buf = st["momentum_buffer"].mul_(group["momentum"])
                p.add_(buf.sub_(u * group["lr"]))


def _factored_dims(shape, min_dim_size_to_factor: int = 128):
    """optax's ``_factored_dims``: the two largest dims ``(d1, d0)`` (d0
    the largest; of equal sizes the later one) when the second largest has
    at least ``min_dim_size_to_factor`` entries, else None."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return order[-2], order[-1]


def _inverse(perm) -> list[int]:
    out = [0] * len(perm)
    for i, j in enumerate(perm):
        out[j] = i
    return out


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor`` at its defaults: ``scale_by_factored_rms``
    (decay ``1 - t^-0.8`` at update t, eps 1e-30; a parameter whose two
    largest dims have >= 128 entries keeps row and column means
    ``v_row``/``v_col``, any other a full ``v``), ``clip_by_block_rms(1)``,
    the learning rate, and ``scale_by_param_block_rms`` (the parameter's
    rms, at least 1e-3).

    optax factors over the flax layout's dims, so ``views`` (name ->
    ``(perm, shape)``, ``models.convert.flax_views``) gives each named
    parameter's flax layout, ``p.permute(perm).reshape(shape)``: the
    moments live in it (the optax state's own shapes, with its (1,)
    placeholders) and the update is computed there.  A parameter without
    a view is its own layout."""

    def __init__(self, params, lr, views=None, decay_rate: float = 0.8,
                 eps: float = 1e-30, min_dim_size_to_factor: int = 128,
                 clipping_threshold: float = 1.0, min_scale: float = 1e-3,
                 capturable: bool = False):
        names, tensors = _split_named(params)
        super().__init__(tensors, {"lr": lr, "capturable": capturable})
        self.hyper = {"decay_rate": decay_rate, "eps": eps,
                      "clipping_threshold": clipping_threshold,
                      "min_scale": min_scale}
        views = views or {}
        self._views = {}
        for i, p in enumerate(tensors):
            perm, shape = views.get(names[i] if names else None,
                                    (tuple(range(p.dim())), tuple(p.shape)))
            self._views[p] = (tuple(perm), tuple(shape), _factored_dims(
                shape, min_dim_size_to_factor))

    @torch.no_grad()
    def step(self, closure=None):
        h = self.hyper
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                perm, shape, dims = self._views[p]
                st = self.state[p]
                count = _count(self, p, group)
                if "v" not in st:
                    _adafactor_init(p, st, shape, dims)
                g = p.grad.permute(perm).reshape(shape)
                decay = 1 - torch.pow(count, -h["decay_rate"])
                sq = g.square() + h["eps"]
                if dims is not None:
                    d1, d0 = dims
                    v_row = st["v_row"].mul_(decay).add_(
                        sq.mean(d0) * (1 - decay))
                    v_col = st["v_col"].mul_(decay).add_(
                        sq.mean(d1) * (1 - decay))
                    row = v_row.mean(d1 - 1 if d1 > d0 else d1, keepdim=True)
                    u = g * torch.pow(v_row / row, -0.5).unsqueeze(d0) \
                        * torch.pow(v_col, -0.5).unsqueeze(d1)
                else:
                    v = st["v"].mul_(decay).add_(sq * (1 - decay))
                    u = g * torch.pow(v, -0.5)
                u = u / torch.clamp(u.square().mean().sqrt()
                                    / h["clipping_threshold"], min=1.0)
                rms = p.square().mean().sqrt()
                scale = torch.where(rms <= h["min_scale"],
                                    torch.full_like(rms, h["min_scale"]),
                                    rms)
                u = u.reshape([p.shape[i] for i in perm]).permute(
                    _inverse(perm))
                _descend(p, u * scale, group["lr"])


def _adafactor_init(p, st, shape, dims) -> None:
    """optax's initial factored state: zeros, and (1,) placeholders for
    the moments a parameter does not keep."""
    def zeros(size):
        return torch.zeros(size, dtype=p.dtype, device=p.device)

    if dims is None:
        st["v_row"], st["v_col"], st["v"] = zeros(1), zeros(1), zeros(shape)
        return
    d1, d0 = dims
    st["v_row"] = zeros([n for i, n in enumerate(shape) if i != d0])
    st["v_col"] = zeros([n for i, n in enumerate(shape) if i != d1])
    st["v"] = zeros(1)


class Lion(torch.optim.Optimizer):
    """``optax.lion``: the update is the sign of ``(1 - b1) g + b1 mu``,
    then ``mu`` (``exp_avg``) moves to ``(1 - b2) g + b2 mu``; decoupled
    decay (the group's ``weight_decay``) and the learning rate follow."""

    def __init__(self, params, lr, b1: float = 0.9, b2: float = 0.99,
                 weight_decay: float = 0.0, capturable: bool = False):
        super().__init__(params, {"lr": lr, "b1": b1, "b2": b2,
                                  "weight_decay": weight_decay,
                                  "capturable": capturable})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2, wd = group["b1"], group["b2"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g, st = p.grad, self.state[p]
                if "exp_avg" not in st:
                    st["exp_avg"] = torch.zeros_like(p)
                mu = st["exp_avg"]
                u = torch.sign(g * (1 - b1) + mu * b1)
                mu.mul_(b2).add_(g, alpha=1 - b2)
                if wd:
                    u = u + wd * p
                _descend(p, u, group["lr"])


def sgd(params, learning_rate: float | Schedule, *,
        momentum: float | None = None, nesterov: bool = False,
        global_clipnorm: float = 0.0) -> torch.optim.Optimizer:
    """``optax.sgd`` (:class:`SGD`) behind optax's chain head
    (:func:`_optax_prelude`: the learning rate of optax's count when
    ``learning_rate`` is a schedule, clipping for ``global_clipnorm``)."""
    lr0 = learning_rate(0) if callable(learning_rate) else learning_rate
    opt = SGD(_split_named(params)[1], lr=lr0, momentum=momentum or 0.0,
              nesterov=nesterov)
    return _optax_prelude(opt, learning_rate, global_clipnorm)


def adagrad(params, learning_rate: float | Schedule, *,
            global_clipnorm: float = 0.0) -> torch.optim.Optimizer:
    """``optax.adagrad`` (:class:`Adagrad`) behind optax's chain head."""
    lr0 = learning_rate(0) if callable(learning_rate) else learning_rate
    return _optax_prelude(Adagrad(_split_named(params)[1], lr0),
                          learning_rate, global_clipnorm)


def _rate0(learning_rate) -> float:
    return learning_rate(0) if callable(learning_rate) else learning_rate


def lamb(params, learning_rate: float | Schedule, *,
         weight_decay: float = 0.0, mask=None,
         global_clipnorm: float = 0.0) -> torch.optim.Optimizer:
    """``optax.lamb`` (:class:`Lamb`) behind optax's chain head; ``mask``
    scopes the decay as :func:`adamw`'s does."""
    groups = _decay_groups(params, weight_decay, mask)
    opt = Lamb(groups, _rate0(learning_rate), capturable=_on_cuda(groups))
    return _optax_prelude(opt, learning_rate, global_clipnorm)


def lars(params, learning_rate: float | Schedule, *,
         weight_decay: float = 0.0, momentum: float = 0.9,
         global_clipnorm: float = 0.0) -> torch.optim.Optimizer:
    """``optax.lars`` (:class:`Lars`) behind optax's chain head."""
    groups = _decay_groups(params, weight_decay, None)
    opt = Lars(groups, _rate0(learning_rate), momentum=momentum,
               capturable=_on_cuda(groups))
    return _optax_prelude(opt, learning_rate, global_clipnorm)


def adafactor(params, learning_rate: float | Schedule, *, views=None,
              global_clipnorm: float = 0.0) -> torch.optim.Optimizer:
    """``optax.adafactor`` (:class:`Adafactor`) behind optax's chain
    head; ``views`` maps parameter names to their flax layouts."""
    params = list(params)
    opt = Adafactor(params, _rate0(learning_rate), views=views,
                    capturable=_on_cuda([{"params":
                                          _split_named(params)[1]}]))
    return _optax_prelude(opt, learning_rate, global_clipnorm)


def lion(params, learning_rate: float | Schedule, *,
         weight_decay: float = 0.0, mask=None,
         global_clipnorm: float = 0.0) -> torch.optim.Optimizer:
    """``optax.lion`` (:class:`Lion`, b1 0.9, b2 0.99) behind optax's
    chain head.  Its decay is the caller's ``weight_decay``
    (``build_optimizer`` passes it, so optax's default of 1e-3 never
    applies)."""
    groups = _decay_groups(params, weight_decay, mask)
    opt = Lion(groups, _rate0(learning_rate), capturable=_on_cuda(groups))
    return _optax_prelude(opt, learning_rate, global_clipnorm)


def build_optimizer(name: str, lr: float | Schedule, *,
                    weight_decay: float = 0.0, momentum: float = 0.9,
                    global_clipnorm: float = 0.0, decay_mask=None,
                    views=None) -> Callable[..., torch.optim.Optimizer]:
    """The --optimizer CLI surface: ``params -> optimizer`` for ``name``.

    Same validation as the JAX builder: ``weight_decay`` is refused for
    optimizers without decoupled decay, ``global_clipnorm`` must be >= 0
    (0 disables it), ``decay_mask`` (:func:`exclude_bias_and_norm_mask`
    or a name -> bool dict) is for adamw/lamb/lion.  ``views``: the
    parameters' flax layouts for adafactor (``models.convert.
    flax_views``)."""
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
        if name in ("lamb", "lion"):
            return (lamb if name == "lamb" else lion)(
                params, lr, weight_decay=weight_decay, mask=decay_mask,
                global_clipnorm=global_clipnorm)
        if name == "lars":
            return lars(params, lr, weight_decay=weight_decay,
                        momentum=momentum, global_clipnorm=global_clipnorm)
        if name == "adafactor":
            return adafactor(params, lr, views=views,
                             global_clipnorm=global_clipnorm)
        opt = adamw(params, lr(0) if callable(lr) else lr,
                    weight_decay=weight_decay, mask=decay_mask)
        return _optax_prelude(opt, lr, global_clipnorm)

    return make
