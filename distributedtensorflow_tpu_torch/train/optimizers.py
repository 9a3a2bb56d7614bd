"""Optimizers of the port: those the ported presets use.

Twin of ``distributedtensorflow_tpu/train/optimizers.py``.  Only AdamW is
ported (``gpt_lm`` builds ``optax.adamw(3e-4, weight_decay=0.1)``,
``workloads.py:500``); the other eight and the schedules are queued in
ROADMAP.md.
"""

from __future__ import annotations

import torch


def adamw(params, learning_rate: float = 3e-4, *, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 1e-4,
          mask=None) -> torch.optim.Optimizer:
    """``optax.adamw`` as a ``torch.optim.AdamW``.

    The two compute the same update: bias-corrected moments, ``eps``
    added outside the square root, and decoupled decay ``lr * wd * p``
    on the parameters before the step (optax adds it to the update; torch
    scales the parameters first, which gives the same values because
    the Adam term does not read them).  optax's defaults: ``weight_decay
    1e-4``, decay on every parameter (``mask=None``); a decay mask is not
    ported."""
    if mask is not None:
        raise NotImplementedError("adamw(mask=...): a weight-decay mask is "
                                  "not ported yet (ROADMAP.md)")
    return torch.optim.AdamW(params, lr=learning_rate, betas=(b1, b2),
                             eps=eps, weight_decay=weight_decay)
