"""The train and eval steps on one device.

Twin of ``distributedtensorflow_tpu/train/engine.py``: ``_step_body``
(``:251-285``) and ``accumulate_gradients`` (``:73-123``).  A step folds
the step counter into the randomness, averages gradients and metrics over
``accum_steps`` microbatches, and applies one optimizer update.  JAX
compiles the step into one program over a mesh; here it runs eagerly on
one device, and data parallelism across devices is not ported yet.

Loss-function contract: ``loss_fn(batch, generator) -> (loss, metrics)``
with ``batch`` a dict of (B, ...) tensors, ``generator`` a CPU
``torch.Generator`` for dropout, ``loss`` a scalar tensor and
``metrics`` a dict of scalar tensors.  JAX's contract also returns the
new model state (``batch_stats``); here BatchNorm's running statistics
are module buffers that each training forward updates in place, so the
microbatches, run one after another, update them once each in order, as
the JAX scan threads ``model_state`` through them.
"""

from __future__ import annotations

import numpy as np
import torch

from .state import TrainState


def step_generator(seed: int, step: int, micro: int = 0) -> torch.Generator:
    """A CPU generator for microbatch ``micro`` of step ``step``: the
    port's ``fold_in(rng, step)`` followed by ``split``, a seed derived
    from ``(seed, step, micro)``."""
    state = np.random.SeedSequence([seed, step, micro]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state) >> 1)


def split_microbatches(batch: dict, accum_steps: int) -> list[dict]:
    """Each leaf (B, ...) cut into ``accum_steps`` (B // accum_steps, ...)
    microbatches."""
    for name, x in batch.items():
        if x.shape[0] % accum_steps:
            raise ValueError(f"batch dim {x.shape[0]} of {name!r} not "
                             f"divisible by accum_steps={accum_steps}")
    return [{k: x.chunk(accum_steps)[i] for k, x in batch.items()}
            for i in range(accum_steps)]


def accumulate_gradients(loss_fn, model: torch.nn.Module, batch: dict, *,
                         seed: int, step: int, accum_steps: int = 1):
    """``(grads, metrics)``: gradients by parameter name and the metrics
    (with ``loss``), each summed over the microbatches and then divided
    by their count, as the JAX scan does."""
    names, params = zip(*model.named_parameters())
    grads, metrics = None, {}
    for i, mb in enumerate(split_microbatches(batch, accum_steps)):
        loss, m = loss_fn(mb, step_generator(seed, step, i))
        gs = torch.autograd.grad(loss, params, allow_unused=True,
                                 materialize_grads=True)
        grads = list(gs) if grads is None else \
            [a.add_(b) for a, b in zip(grads, gs)]
        for k, val in dict(m, loss=loss).items():
            val = val.detach()
            metrics[k] = val if k not in metrics else metrics[k] + val
    if accum_steps > 1:
        inv = 1.0 / accum_steps
        grads = [g.mul_(inv) for g in grads]
        metrics = {k: val * inv for k, val in metrics.items()}
    return dict(zip(names, grads)), metrics


def make_train_step(loss_fn, *, accum_steps: int = 1, seed: int = 0):
    """``step(state, batch) -> (state, metrics)``: gradients of
    ``loss_fn`` averaged over ``accum_steps`` microbatches, then one
    update of ``state`` (in place)."""

    def step(state: TrainState, batch: dict):
        grads, metrics = accumulate_gradients(
            loss_fn, state.model, batch, seed=seed, step=state.step,
            accum_steps=accum_steps)
        return state.apply_gradients(grads), metrics

    return step


def make_eval_step(metric_fn):
    """``eval_step(state, batch) -> metrics`` for a ``metric_fn(batch)``
    over the state's model (``lm_eval`` runs without autograd)."""

    def eval_step(state: TrainState, batch: dict):
        return metric_fn(batch)

    return eval_step
