"""Train state: the step, the model's parameters and the optimizer.

Twin of ``distributedtensorflow_tpu/train/state.py`` (``TrainState``,
``:29-50``).  JAX's state is an immutable pytree and ``apply_gradients``
returns a new one; here the parameters and the optimizer's moments live
in the model and the optimizer and are updated in place, which keeps one
copy of each on the card.  ``apply_gradients`` returns the same state;
it is the one update of both the single step and every step of a
multi-step call (a replayed CUDA graph of k updates is recorded on the
host by :meth:`advance`).
JAX's ``model_state`` (BatchNorm's ``batch_stats``) is the model's
buffers here.  JAX's state is one global array per leaf; a data-parallel
mesh here holds one replica a rank, made equal when the state is built
(:meth:`TrainState.create` broadcasts rank 0's parameters and buffers)
and kept equal by applying the same global gradients on every rank.
Under ZeRO (``zero``) the optimizer holds this rank's rows of the
parameters only, and the update is the sharder's.
"""

from __future__ import annotations

import collections
import copy
import dataclasses

import torch
from torch import nn

from ..parallel import collectives


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    #: ZeRO's sharder (``parallel.zero.ZeroSharder``): the optimizer
    #: holds this rank's rows of the parameters, and the updates go
    #: through the sharder
    zero: object = None
    #: the model's bucketed gradient sync (``parallel.overlap.
    #: OverlapPlan``), which the data-parallel step runs in the backward
    overlap: object = None
    #: the pieces of a model split over ``model``, ``expert`` or ``pipe``
    #: (``parallel.placement.Placement``): the optimizer's norms and the
    #: checkpoints take the whole parameters through it
    placement: object = None

    @classmethod
    def create(cls, model: nn.Module, make_optimizer, mesh=None,
               zero=None) -> "TrainState":
        """Step 0 of ``model`` with ``make_optimizer(named_parameters)``;
        over a ``mesh``, rank 0's parameters and buffers first copied to
        every rank of its batch group; with ``zero`` the optimizer is
        built over this rank's rows (``ZeroSharder.shard_optimizer``)."""
        if mesh is not None:
            with torch.no_grad():
                for t in [*model.parameters(), *model.buffers()]:
                    t.copy_(collectives.broadcast(t, mesh, src=0))
        if zero is not None:
            return cls(0, model, zero.shard_optimizer(model, make_optimizer),
                       zero)
        return cls(0, model, make_optimizer(list(model.named_parameters())))

    def apply_gradients(self, grads: dict[str, torch.Tensor]
                        ) -> "TrainState":
        """One optimizer update from ``grads`` (parameter name -> tensor),
        then ``step + 1``; a ZeRO state's update is the sharder's (the
        gradients this rank's local sums)."""
        if self.zero is not None:
            return self.zero.apply_gradients(self, grads)
        for name, p in self.model.named_parameters():
            p.grad = grads[name]
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return self

    def snapshot(self) -> "TrainState":
        """A deep copy of the step, the parameters, the buffers and the
        optimizer state (JAX ``TrainState.snapshot``, ``train/state.py:52``),
        on the device they live on: safe to hand to a
        :class:`~..parallel.Coordinator` closure while training goes on
        updating this state in place.  The copy is for reading (an eval,
        a save): its ``zero`` and ``placement`` are this state's layouts
        and it has no ``overlap`` hooks.  A model's process groups are
        shared, not copied."""
        memo: dict = {}
        for mod in self.model.modules():  # groups and meshes stay shared
            for key in ("group", "mesh"):
                value = mod.__dict__.get(key)
                if value is not None:
                    memo[id(value)] = value
        with torch.no_grad():
            model = copy.deepcopy(self.model, memo)
            opt = self.optimizer
            # not deepcopy(opt): Optimizer.__getstate__ keeps only its
            # defaults, state and groups, and the port's optimizers carry
            # their schedule and rate table beside them
            new = object.__new__(type(opt))
            new.__dict__.update(opt.__dict__)
            new.param_groups = [
                {k: [copy.deepcopy(p, memo) for p in v] if k == "params"
                 else copy.deepcopy(v) for k, v in group.items()}
                for group in opt.param_groups]
            new.state = collections.defaultdict(dict, {
                copy.deepcopy(p, memo): copy.deepcopy(st)
                for p, st in opt.state.items()})
        return dataclasses.replace(self, model=model, optimizer=new,
                                   overlap=None)

    def advance(self, k: int) -> "TrainState":
        """``step`` and the optimizer's schedule count ``k`` further: the
        host's record of ``k`` updates that a replayed CUDA graph applied
        without running :meth:`apply_gradients`'s Python."""
        from .optimizers import advance_schedule

        advance_schedule(self.optimizer, k)
        self.step += k
        return self


def create_sharded_state(model: nn.Module, make_optimizer, mesh, *, cfg,
                         rules=None, zero=None):
    """Step 0 of ``model`` (whole, its weights loaded) laid out on
    ``mesh`` (JAX ``create_sharded_state``, ``train/state.py:72``): split
    over ``model`` by the ``rules`` LayoutMap
    (``parallel.sharding.bind_tensor_parallel``), replicated over the
    batch axes, its optimizer over this rank's parameters (or, with a
    ``zero`` sharder bound to the specs, this rank's rows of them).
    The expert stacks are cut to this rank's over ``expert``
    (``parallel.sharding.shard_expert_stacks``).
    A model split over ``model``, ``expert`` or ``pipe`` gets its
    ``placement`` (``parallel.placement``), bound to the optimizer.
    Returns ``(state, specs)``: the parameters' PartitionSpecs by name,
    from the rules on their flax paths (``cfg`` names the model).
    JAX's ``fsdp=True`` (parameters sharded over ``fsdp`` and gathered
    for each use) is not ported: ``fsdp`` is a batch axis here."""
    from ..models.convert import flax_paths
    from ..parallel.placement import Placement
    from ..parallel.sharding import (
        P,
        bind_tensor_parallel,
        shard_expert_stacks,
    )

    specs = {name: rules.spec("/".join(path)) if rules is not None else P()
             for name, path in flax_paths(cfg).items()}
    placement = Placement.of(model, mesh, cfg=cfg, layout=rules)
    bind_tensor_parallel(model, cfg, rules, mesh)
    shard_expert_stacks(model, cfg, rules, mesh)
    if zero is not None:
        zero.bind(specs)
    state = TrainState.create(model, make_optimizer, mesh, zero=zero)
    if placement.split:
        placement.bind(state.optimizer, zero)
        state.placement = placement
    return state, specs
