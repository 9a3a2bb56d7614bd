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
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..parallel import collectives


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer

    @classmethod
    def create(cls, model: nn.Module, make_optimizer, mesh=None
               ) -> "TrainState":
        """Step 0 of ``model`` with ``make_optimizer(named_parameters)``;
        over a ``mesh``, rank 0's parameters and buffers first copied to
        every rank."""
        if mesh is not None:
            with torch.no_grad():
                for t in [*model.parameters(), *model.buffers()]:
                    t.copy_(collectives.broadcast(t, mesh, src=0))
        return cls(0, model, make_optimizer(list(model.named_parameters())))

    def apply_gradients(self, grads: dict[str, torch.Tensor]) -> "TrainState":
        """One optimizer update from ``grads`` (parameter name -> tensor),
        then ``step + 1``."""
        for name, p in self.model.named_parameters():
            p.grad = grads[name]
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return self

    def advance(self, k: int) -> "TrainState":
        """``step`` and the optimizer's schedule count ``k`` further: the
        host's record of ``k`` updates that a replayed CUDA graph applied
        without running :meth:`apply_gradients`'s Python."""
        from .optimizers import advance_schedule

        advance_schedule(self.optimizer, k)
        self.step += k
        return self
