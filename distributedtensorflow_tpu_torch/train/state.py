"""Train state: the step, the model's parameters and the optimizer.

Twin of ``distributedtensorflow_tpu/train/state.py`` (``TrainState``,
``:29-50``).  JAX's state is an immutable pytree and ``apply_gradients``
returns a new one; here the parameters and the optimizer's moments live
in the model and the optimizer and are updated in place, which keeps one
copy of each on the card.  ``apply_gradients`` returns the same state.
JAX's ``model_state`` (BatchNorm's ``batch_stats``) is the model's
buffers here.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer

    def apply_gradients(self, grads: dict[str, torch.Tensor]) -> "TrainState":
        """One optimizer update from ``grads`` (parameter name -> tensor),
        then ``step + 1``."""
        for name, p in self.model.named_parameters():
            p.grad = grads[name]
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return self
