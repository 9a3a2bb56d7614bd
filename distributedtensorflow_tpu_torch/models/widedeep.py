"""Wide&Deep recommender: the ``widedeep`` preset's model and losses.

Twin of ``distributedtensorflow_tpu/models/widedeep.py`` (``:30-123``):
per categorical feature a deep embedding (a bf16 lookup of an fp32
table) and a wide scalar weight (an fp32 ``Embed(vocab, 1)``); the deep
embeddings and the dense features go through a ReLU MLP to one fp32
logit, to which the wide weights and an fp32 linear model of the dense
features add.  The loss is sigmoid binary cross-entropy.  JAX's
embedding gradient is dense, so the tables here take dense gradients too
(an indexed read, not ``sparse=True``) and adagrad updates every row as
optax's does.  Submodules carry the flax tree's names (``embed_{i}``,
``wide_{i}``, ``mlp_{j}``, ``deep_out``, ``wide_dense``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..parallel.collectives import share_of_mean
from ..parallel.sharding import LayoutMap, P
from .layers import Dense, embed_rows


@dataclasses.dataclass(frozen=True)
class WideDeepConfig:
    #: one vocab size per categorical feature
    vocab_sizes: tuple[int, ...] = (100_000, 10_000, 1_000, 100)
    embed_dim: int = 64
    num_dense_features: int = 13
    mlp_dims: tuple[int, ...] = (1024, 512, 256)
    dtype: torch.dtype = torch.bfloat16


def widedeep_test_config() -> WideDeepConfig:
    return WideDeepConfig(vocab_sizes=(512, 128), embed_dim=8,
                          num_dense_features=4, mlp_dims=(32, 16))


class WideDeep(nn.Module):
    """``forward(categorical, dense)``: ``categorical`` (B, n_cat) ids,
    ``dense`` (B, n_dense) floats -> fp32 logits (B,)."""

    def __init__(self, cfg: WideDeepConfig = WideDeepConfig(), *,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        for i, vocab in enumerate(cfg.vocab_sizes):
            self.add_module(f"embed_{i}", nn.Embedding(vocab, cfg.embed_dim,
                                                       device=device))
            self.add_module(f"wide_{i}", nn.Embedding(vocab, 1,
                                                      device=device))
        width = len(cfg.vocab_sizes) * cfg.embed_dim + cfg.num_dense_features
        for j, dim in enumerate(cfg.mlp_dims):
            self.add_module(f"mlp_{j}", Dense(width, dim, dtype=cfg.dtype,
                                              use_bias=True, device=device))
            width = dim
        self.deep_out = Dense(width, 1, dtype=torch.float32, use_bias=True,
                              device=device)
        self.wide_dense = Dense(cfg.num_dense_features, 1,
                                dtype=torch.float32, use_bias=True,
                                device=device)

    @property
    def device(self) -> torch.device:
        return self.deep_out.weight.device

    def forward(self, categorical, dense):
        cfg = self.cfg
        n = len(cfg.vocab_sizes)
        embeds = [embed_rows(getattr(self, f"embed_{i}"), categorical[:, i])
                  .to(cfg.dtype) for i in range(n)]
        wide = [embed_rows(getattr(self, f"wide_{i}"), categorical[:, i])[:, 0]
                for i in range(n)]
        deep = torch.cat(embeds + [dense.to(cfg.dtype)], dim=-1)
        for j in range(len(cfg.mlp_dims)):
            deep = F.relu(getattr(self, f"mlp_{j}")(deep))
        deep_logit = self.deep_out(deep)[:, 0]
        wide_logit = sum(wide) + self.wide_dense(dense.float())[:, 0]
        return deep_logit + wide_logit


def widedeep_layout() -> LayoutMap:
    """The embedding tables split by rows over ``model`` (JAX
    ``widedeep_layout``, ``models/widedeep.py:83-88``)."""
    return LayoutMap([
        (r"embed_\d+/embedding", P("model", None)),
        (r"wide_\d+/embedding", P("model", None)),
    ])


def _forward_metrics(model: WideDeep, batch):
    """The loss and accuracy shared by the train and eval metrics (JAX
    ``_forward_metrics``, ``:91-102``)."""
    logits = model(batch["categorical"], batch["dense"])
    labels = batch["label"].float()
    loss = F.binary_cross_entropy_with_logits(logits, labels)
    accuracy = ((logits > 0) == (labels > 0.5)).float().mean()
    return loss, accuracy


def widedeep_loss(model: WideDeep, group=None):
    """``loss_fn(batch, generator=None) -> (loss, {"accuracy"})`` for
    batches ``{categorical, dense, label}``; over a data-parallel
    ``group`` (or mesh) this rank's shares of the global means."""

    def loss_fn(batch, generator=None):
        loss, accuracy = _forward_metrics(model, batch)
        if group is not None:
            share = share_of_mean(batch["label"].shape[0], group)
            loss, accuracy = loss * share, accuracy * share
        return loss, {"accuracy": accuracy}

    return loss_fn


def widedeep_eval(model: WideDeep, group=None):
    """``metric_fn(batch) -> {"accuracy", "log_loss"}`` without
    autograd; over a data-parallel ``group`` this rank's shares of the
    global means."""

    def metric_fn(batch):
        with torch.no_grad():
            loss, accuracy = _forward_metrics(model, batch)
        if group is not None:
            share = share_of_mean(batch["label"].shape[0], group)
            loss, accuracy = loss * share, accuracy * share
        return {"accuracy": accuracy, "log_loss": loss}

    return metric_fn
