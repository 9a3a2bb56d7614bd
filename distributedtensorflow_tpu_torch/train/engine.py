"""The train and eval steps, on one device or over the ranks of a mesh.

Twin of ``distributedtensorflow_tpu/train/engine.py``: ``_step_body``
(``:251-285``) and ``accumulate_gradients`` (``:73-123``).  A step folds
the step counter into the randomness, averages gradients and metrics over
``accum_steps`` microbatches, and applies one optimizer update.  JAX
compiles the step into one program over a mesh that sees the *global*
batch; here each rank of a data-parallel mesh runs the step eagerly on
its share of the batch, and the step is built so that the sum over the
ranks is JAX's step on the global batch (:func:`accumulate_gradients_dp`).

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

from ..parallel import collectives
from ..parallel.mesh import replica_index
from .state import TrainState


def step_generator(seed: int, step: int, micro: int = 0,
                   rank: int = 0) -> torch.Generator:
    """A CPU generator for microbatch ``micro`` of step ``step`` on replica
    ``rank``: the port's ``fold_in(rng, step)`` followed by ``split``, a
    seed derived from ``(seed, step, micro)`` and, for ``rank`` > 0, the
    rank (JAX draws one dropout mask over the global batch, so each
    replica's rows get their own bits; replica 0 draws what one device
    draws)."""
    key = [seed, step, micro] + ([rank] if rank else [])
    state = np.random.SeedSequence(key).generate_state(1, np.uint64)[0]
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


def _microbatch_grads(loss_fn, model, batch, seed, step, accum_steps,
                      rank=0):
    """``(names, grads, metrics)``: the parameters' names, their gradients
    summed over the microbatches, and each microbatch's metrics with its
    loss."""
    names, params = zip(*model.named_parameters())
    grads, metrics = None, []
    for i, mb in enumerate(split_microbatches(batch, accum_steps)):
        loss, m = loss_fn(mb, step_generator(seed, step, i, rank))
        gs = torch.autograd.grad(loss, params, allow_unused=True,
                                 materialize_grads=True)
        grads = list(gs) if grads is None else \
            [a.add_(b) for a, b in zip(grads, gs)]
        metrics.append({k: v.detach() for k, v in dict(m, loss=loss).items()})
    return names, grads, metrics


def _average(names, grads, metrics, accum_steps):
    """The gradients and the microbatches' metrics, each summed and then
    divided by the count of microbatches, as the JAX scan does."""
    total = {}
    for m in metrics:
        for k, val in m.items():
            total[k] = val if k not in total else total[k] + val
    if accum_steps > 1:
        inv = 1.0 / accum_steps
        grads = [g.mul_(inv) for g in grads]
        total = {k: val * inv for k, val in total.items()}
    return dict(zip(names, grads)), total


def accumulate_gradients(loss_fn, model: torch.nn.Module, batch: dict, *,
                         seed: int, step: int, accum_steps: int = 1):
    """``(grads, metrics)``: gradients by parameter name and the metrics
    (with ``loss``), each summed over the microbatches and then divided
    by their count, as the JAX scan does."""
    return _average(*_microbatch_grads(loss_fn, model, batch, seed, step,
                                       accum_steps), accum_steps)


def _finalize(metrics: dict) -> dict:
    """Global metrics from summed shares: ``log_<name>`` becomes
    ``<name> = exp(sum)`` (perplexity is the exp of the global loss, not
    a sum of per-rank exps)."""
    return {(k[4:] if k.startswith("log_") else k):
            (torch.exp(v) if k.startswith("log_") else v)
            for k, v in metrics.items()}


def accumulate_gradients_dp(loss_fn, model: torch.nn.Module, batch: dict,
                            mesh, *, seed: int, step: int,
                            accum_steps: int = 1):
    """:func:`accumulate_gradients` for one rank of a data-parallel mesh:
    the global ``(grads, metrics)`` of JAX's step on the global batch.

    ``batch`` holds this rank's share of each microbatch (the layout of
    :func:`..data.device_put_batch`) and ``loss_fn`` was built for the
    mesh: it returns this rank's *share* of the microbatch's loss and
    metrics, numerators over its rows and denominators over every rank's,
    so that the global value is the sum of the shares over the ranks
    (a ``log_<name>`` metric is the share of a log, see
    :func:`_finalize`).  The gradients of the shares, accumulated over the
    microbatches, and every microbatch's metric shares go through one
    :func:`..parallel.collectives.packed_all_reduce` (SUM, in packs of
    ``DEFAULT_BYTES_PER_PACK``) a step, after the last backward, as JAX
    sums the gradients once after its scan.
    Then both are averaged over the microbatches.  For a world of one the
    shares are the losses themselves and this is
    :func:`accumulate_gradients` bit for bit."""
    names, grads, shares = _microbatch_grads(
        loss_fn, model, batch, seed, step, accum_steps, replica_index(mesh))
    keys = list(shares[0])
    table = torch.stack([torch.stack([s[k].float() for k in keys])
                         for s in shares])  # (accum, metrics)
    *grads, table = collectives.packed_all_reduce(
        grads + [table], mesh,
        options=collectives.Options(collectives.DEFAULT_BYTES_PER_PACK))
    return _average(names, grads,
                    [_finalize(dict(zip(keys, row))) for row in table],
                    accum_steps)


def make_train_step(loss_fn, *, accum_steps: int = 1, seed: int = 0,
                    mesh=None):
    """``step(state, batch) -> (state, metrics)``: gradients of
    ``loss_fn`` averaged over ``accum_steps`` microbatches, then one
    update of ``state`` (in place).  With a ``mesh`` the step is one
    rank's of the data-parallel step (:func:`accumulate_gradients_dp`;
    ``loss_fn`` built for the mesh) and every rank applies the same
    global gradients."""

    def step(state: TrainState, batch: dict):
        if mesh is None:
            grads, metrics = accumulate_gradients(
                loss_fn, state.model, batch, seed=seed, step=state.step,
                accum_steps=accum_steps)
        else:
            grads, metrics = accumulate_gradients_dp(
                loss_fn, state.model, batch, mesh, seed=seed,
                step=state.step, accum_steps=accum_steps)
        return state.apply_gradients(grads), metrics

    return step


def make_eval_step(metric_fn):
    """``eval_step(state, batch) -> metrics`` for a ``metric_fn(batch)``
    over the state's model (``lm_eval`` runs without autograd)."""

    def eval_step(state: TrainState, batch: dict):
        return metric_fn(batch)

    return eval_step
