"""Classification losses of the port.

Twin of ``distributedtensorflow_tpu/train/losses.py`` (``:37-100``):
softmax cross-entropy for image classifiers with an optional loss-side
L2 term, and the eval metrics.  The model's forward takes ``train``:
with it BatchNorm normalises with the batch's statistics and updates its
running ones (the buffers the JAX loss returns as ``new_model_state``);
without it (eval) it uses the running ones and leaves them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.collectives import group_rank, share_of_mean


def classification_loss(model, *, weight_decay: float = 0.0,
                        inputs_key: str = "image", labels_key: str = "label",
                        group=None):
    """``loss_fn(batch, generator=None) -> (loss, {"accuracy"})``: the
    mean cross-entropy of the fp32 logits, plus ``0.5 * weight_decay *
    sum(p ** 2)`` over the parameters of rank > 1 (conv and dense
    kernels, never BatchNorm scales or biases) when ``weight_decay``.
    Over a data-parallel ``group`` (or mesh) the cross-entropy and the
    accuracy are this rank's shares of the global means and the L2 term,
    over the replicated parameters, enters once: on rank 0's share."""

    def loss_fn(batch, generator=None):
        logits = model(batch[inputs_key], train=True).float()
        labels = batch[labels_key]
        loss = F.cross_entropy(logits, labels)
        accuracy = (logits.argmax(-1) == labels).float().mean()
        if group is not None:
            share = share_of_mean(labels.shape[0], group)
            loss, accuracy = loss * share, accuracy * share
        if weight_decay and (group is None or group_rank(group) == 0):
            l2 = sum(p.square().sum() for p in model.parameters()
                     if p.dim() > 1)
            loss = loss + 0.5 * weight_decay * l2
        return loss, {"accuracy": accuracy}

    return loss_fn


def classification_eval(model, *, inputs_key: str = "image",
                        labels_key: str = "label", top5: bool = False):
    """``metric_fn(batch) -> {"loss", "accuracy"[, "top5_accuracy"]}``:
    the running statistics, no update, no autograd.  ``top5`` adds the
    share of rows whose label is among the five largest logits."""

    def metric_fn(batch):
        with torch.no_grad():
            logits = model(batch[inputs_key], train=False).float()
        labels = batch[labels_key]
        metrics = {"loss": F.cross_entropy(logits, labels),
                   "accuracy": (logits.argmax(-1) == labels).float().mean()}
        if top5:
            top = logits.topk(min(5, logits.shape[-1]), dim=-1).indices
            metrics["top5_accuracy"] = (
                (top == labels[:, None]).any(-1).float().mean())
        return metrics

    return metric_fn
