"""Training presets of the port: the GPT language-model family and the
five BASELINE.json workloads.

Twin of ``distributedtensorflow_tpu/workloads.py`` with the same
defaults:

- ``gpt_lm``, ``gpt_medium_lm``, ``lm_long_context`` (``:403-510``) and
  ``gpt_moe`` (``:566-612``): GPT-2-small (or -medium, or GPT-2-small with
  eight experts on every second block) at seq 2048, global batch 64,
  AdamW at 3e-4 with weight decay 0.1, synthetic next-token batches;
  ``lm_long_context`` is GPT-2-small at seq 8192 with attention-only
  remat and the flash kernels forced; ``test_size`` gives ``gpt_tiny``
  (``gpt_moe_tiny``) at seq 64, batch 8.
- ``mnist_lenet``, ``cifar_resnet20``, ``imagenet_resnet50``,
  ``bert_mlm``, ``bert_mlm_packed`` and ``widedeep`` (``:257-401``):
  LeNet-5 (batch 128, sgd 0.05 with momentum 0.9), ResNet-20 (batch 256,
  nesterov sgd 0.1, loss-side L2 1e-4; fp32 at test size), ResNet-50
  (global batch 1024, nesterov sgd on a warmup-cosine schedule, L2 1e-4,
  top-5 in eval; 64x64 at test size), BERT-base MLM at seq 512 (batch
  256 in 4 accumulated microbatches, AdamW 1e-4 with decay 0.01, the
  gathered head; ``bert_tiny`` at seq 128 at test size), its packed
  variant, and Wide&Deep (batch 4096, adagrad 0.01;
  ``widedeep_test_config`` at test size).

The synthetic sources are copies of the JAX package's numpy sources
with the same seeds, so both packages see identical batches; over a
data-parallel mesh each rank's source is seeded by ``seed +
input_pipeline_id``, as each JAX host's is.  The other presets
(``imagenet_vit``, ``bert_moe``, ``t5_seq2seq``) and the
pipeline/sequence/expert-parallel variants are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

import numpy as np
import torch

from .data import InputContext, pack_sequences, synthetic_classification
from .models.bert import (
    BertForMLM,
    bert_base,
    bert_tiny,
    max_predictions_for,
    mlm_eval,
    mlm_loss,
)
from .models.convert import init_params
from .models.gpt import (
    GPTConfig,
    GPTLM,
    gpt_medium,
    gpt_small,
    gpt_tiny,
    lm_eval,
    lm_loss,
)
from .models.gpt_moe import (
    GPTMoELM,
    gpt_moe_small,
    gpt_moe_tiny,
    moe_lm_eval,
    moe_lm_loss,
)
from .models.lenet import LeNet5, LeNetConfig
from .models.resnet import (
    CifarResNet,
    CifarResNetConfig,
    ImageNetResNet,
    ImageNetResNetConfig,
)
from .models.widedeep import (
    WideDeep,
    WideDeepConfig,
    widedeep_eval,
    widedeep_loss,
    widedeep_test_config,
)
from .train.losses import classification_eval, classification_loss
from .train.optimizers import adagrad, adamw, sgd, warmup_cosine_decay_schedule

#: The presets the port has.
WORKLOADS = ("mnist_lenet", "cifar_resnet20", "imagenet_resnet50",
             "bert_mlm", "bert_mlm_packed", "widedeep",
             "gpt_lm", "gpt_medium_lm", "lm_long_context", "gpt_moe")


def synthetic_lm(ctx: InputContext, *, vocab_size: int, seq_len: int,
                 seed: int = 0) -> Iterator[dict]:
    """Synthetic next-token LM batches (structured so loss can fall)."""
    rng = np.random.default_rng(seed + ctx.input_pipeline_id)
    n = ctx.per_host_batch_size
    while True:
        # arithmetic sequences mod vocab: the next token follows from the
        # previous two
        start = rng.integers(0, vocab_size, size=(n, 1))
        step = rng.integers(1, 7, size=(n, 1))
        ids = (start + step * np.arange(seq_len)) % vocab_size
        yield {"input_ids": ids.astype(np.int32)}


def synthetic_mlm(ctx: InputContext, *, vocab_size: int, seq_len: int,
                  mask_rate: float = 0.15, seed: int = 0) -> Iterator[dict]:
    """Synthetic masked-LM batches with the -100 ignore convention."""
    rng = np.random.default_rng(seed + ctx.input_pipeline_id)
    n = ctx.per_host_batch_size
    while True:
        ids = rng.integers(4, vocab_size, size=(n, seq_len))
        mask = rng.random((n, seq_len)) < mask_rate
        labels = np.where(mask, ids, -100)
        inputs = np.where(mask, 3, ids)  # 3 = [MASK]
        yield {
            "input_ids": inputs.astype(np.int32),
            "labels": labels.astype(np.int32),
            "attention_mask": np.ones((n, seq_len), np.int32),
        }


def synthetic_packed_mlm(ctx: InputContext, *, vocab_size: int,
                         seq_len: int, mask_rate: float = 0.15,
                         seed: int = 0) -> Iterator[dict]:
    """Packed masked-LM batches: examples of seq_len/4 to 3 seq_len/4
    tokens packed into rows by :func:`data.pack_sequences`, with
    ``segment_ids``/``position_ids`` so attention stays within an
    example."""
    rng = np.random.default_rng(seed + ctx.input_pipeline_id)
    n = ctx.per_host_batch_size

    def examples():
        while True:
            length = int(rng.integers(seq_len // 4, 3 * seq_len // 4))
            ids = rng.integers(4, vocab_size, size=(length,))
            mask = rng.random(length) < mask_rate
            yield {
                "input_ids": np.where(mask, 3, ids),  # 3 = [MASK]
                "labels": np.where(mask, ids, -100),
            }

    rows = pack_sequences(examples(), seq_len, extra_keys=("labels",))
    while True:
        batch = [next(rows) for _ in range(n)]
        yield {
            k: np.stack([r[k] for r in batch]).astype(np.int32)
            for k in batch[0]
        }


def synthetic_recsys(ctx: InputContext, cfg: WideDeepConfig, seed: int = 0):
    """Synthetic Wide&Deep batches: uniform ids per vocab, normal dense
    features, a label from the first id's parity and the first dense
    feature's sign."""
    rng = np.random.default_rng(seed + ctx.input_pipeline_id)
    n = ctx.per_host_batch_size
    vocabs = np.array(cfg.vocab_sizes)
    while True:
        cat = (rng.random((n, len(vocabs))) * vocabs).astype(np.int32)
        dense = rng.standard_normal((n, cfg.num_dense_features)).astype(
            np.float32)
        label = ((cat[:, 0] % 2) ^ (dense[:, 0] > 0)).astype(np.int32)
        yield {"categorical": cat, "dense": dense, "label": label}


@dataclasses.dataclass
class Workload:
    name: str
    #: the model's config: ``model_cls(cfg, device=...)`` builds it
    cfg: Any
    #: tokens a row (the LM and MLM presets), else None
    seq_len: int | None
    global_batch_size: int
    #: ``(model, group=None) -> loss_fn(batch, generator) -> (loss,
    #: metrics)``; with a data-parallel group (or mesh) the loss and
    #: metrics are this rank's shares (``train.engine``)
    loss_fn: Callable[..., Callable]
    #: model -> ``metric_fn(batch) -> metrics``
    eval_fn: Callable[[torch.nn.Module], Callable]
    #: parameters -> optimizer
    make_optimizer: Callable
    #: ``(ctx, seed) -> iterator of numpy batches``
    input_fn: Callable[[InputContext, int], Iterator[dict]]
    accum_steps: int = 1
    #: ``(cfg, device=...) -> model``
    model_cls: Callable = GPTLM
    #: ``(cfg, generator) -> state_dict`` of seeded weights
    init_params: Callable = init_params
    #: the model's forward reduces over the batch (BatchNorm statistics,
    #: MoE routing): over a mesh it is built with ``group=`` the mesh
    model_takes_group: bool = False


def _image_input(shape, classes):
    def input_fn(ctx: InputContext, seed: int):
        return synthetic_classification(ctx, image_shape=shape,
                                        num_classes=classes, seed=seed)
    return input_fn


def _baseline(name: str, *, test_size: bool, global_batch_size: int | None,
              seq_len: int | None) -> Workload:
    """The BASELINE.json presets (``workloads.py:257-401``)."""
    if name == "mnist_lenet":
        return Workload(
            name=name, cfg=LeNetConfig(), seq_len=None,
            global_batch_size=global_batch_size or 128,
            loss_fn=classification_loss, eval_fn=classification_eval,
            make_optimizer=lambda params: sgd(params, 0.05, momentum=0.9),
            input_fn=_image_input((28, 28, 1), 10), model_cls=LeNet5)
    if name == "cifar_resnet20":
        cfg = CifarResNetConfig(
            dtype=torch.float32 if test_size else torch.bfloat16)
        return Workload(
            name=name, cfg=cfg, seq_len=None,
            global_batch_size=global_batch_size or 256,
            loss_fn=lambda m, group=None: classification_loss(
                m, weight_decay=1e-4, group=group),
            eval_fn=classification_eval,
            make_optimizer=lambda params: sgd(params, 0.1, momentum=0.9,
                                              nesterov=True),
            input_fn=_image_input((32, 32, 3), 10), model_cls=CifarResNet,
            model_takes_group=True)
    if name == "imagenet_resnet50":
        size = (64, 64, 3) if test_size else (224, 224, 3)
        return Workload(
            name=name, cfg=ImageNetResNetConfig(), seq_len=None,
            global_batch_size=global_batch_size or 1024,
            loss_fn=lambda m, group=None: classification_loss(
                m, weight_decay=1e-4, group=group),
            eval_fn=lambda m: classification_eval(m, top5=True),
            make_optimizer=lambda params: sgd(
                params, warmup_cosine_decay_schedule(0.0, 0.8, 1563,
                                                     112_590),
                momentum=0.9, nesterov=True),
            input_fn=_image_input(size, 1000), model_cls=ImageNetResNet,
            model_takes_group=True)
    if name in ("bert_mlm", "bert_mlm_packed"):
        cfg = bert_tiny() if test_size else bert_base()
        seq = seq_len or (128 if test_size else 512)
        if seq > cfg.max_position:
            cfg = dataclasses.replace(cfg, max_position=seq)
        source = synthetic_packed_mlm if name.endswith("_packed") \
            else synthetic_mlm
        p = max_predictions_for(seq)
        return Workload(
            name=name, cfg=cfg, seq_len=seq,
            global_batch_size=global_batch_size or 256,
            loss_fn=lambda m, group=None: mlm_loss(m, max_predictions=p,
                                                   group=group),
            eval_fn=lambda m: mlm_eval(m, max_predictions=p),
            make_optimizer=lambda params: adamw(params, 1e-4,
                                                weight_decay=0.01),
            input_fn=lambda ctx, seed: source(
                ctx, vocab_size=cfg.vocab_size, seq_len=seq, seed=seed),
            accum_steps=4, model_cls=BertForMLM)
    cfg = widedeep_test_config() if test_size else WideDeepConfig()
    return Workload(
        name=name, cfg=cfg, seq_len=None,
        global_batch_size=global_batch_size or 4096,
        loss_fn=widedeep_loss, eval_fn=widedeep_eval,
        make_optimizer=lambda params: adagrad(params, 0.01),
        input_fn=lambda ctx, seed: synthetic_recsys(ctx, cfg, seed),
        model_cls=WideDeep)


def _apply_gpt_overrides(cfg: GPTConfig, *, seq, remat, attn_impl, xent_impl,
                         kv_heads, attn_window) -> GPTConfig:
    """The CLI knobs (``_apply_gpt_overrides``, ``workloads.py:181``):
    remat True/False = whole blocks, "attn" = attention only."""
    return dataclasses.replace(
        cfg,
        remat=cfg.remat if remat is None else remat is True,
        remat_attn=cfg.remat_attn if remat is None else remat == "attn",
        attn_impl=attn_impl or cfg.attn_impl,
        xent_impl=xent_impl or cfg.xent_impl,
        num_kv_heads=kv_heads if kv_heads is not None else cfg.num_kv_heads,
        attn_window=(attn_window if attn_window is not None
                     else cfg.attn_window),
        max_seq=max(cfg.max_seq, seq),
    )


def get_workload(name: str, *, test_size: bool = False,
                 global_batch_size: int | None = None,
                 seq_len: int | None = None,
                 remat: bool | str | None = None,
                 attn_impl: str | None = None,
                 xent_impl: str | None = None,
                 kv_heads: int | None = None,
                 attn_window: int | None = None) -> Workload:
    """Build a ported preset by name; ``test_size`` shrinks the model.
    The GPT knobs (``remat`` ... ``attn_window``) apply to the GPT family
    only, as in JAX."""
    if name not in WORKLOADS:
        raise ValueError(f"workload {name!r} is not ported; the port has "
                         f"{', '.join(WORKLOADS)}")
    if not name.startswith(("gpt", "lm_")):
        return _baseline(name, test_size=test_size,
                         global_batch_size=global_batch_size,
                         seq_len=seq_len)
    moe = name == "gpt_moe"
    if moe:
        cfg = gpt_moe_tiny() if test_size else gpt_moe_small()
    elif test_size:
        cfg = gpt_tiny()
    elif name == "gpt_medium_lm":
        cfg = gpt_medium()
    else:
        cfg = gpt_small()
    if name == "lm_long_context" and not test_size:
        # the long-context preset: 8k tokens, the flash kernels (their
        # backward keeps no (S, S) tensor), attention-only remat; any
        # knob still overrides
        seq_len = seq_len or 8192
        remat = "attn" if remat is None else remat
        attn_impl = attn_impl or "pallas"
    seq = seq_len or (64 if test_size else 2048)
    cfg = _apply_gpt_overrides(cfg, seq=seq, remat=remat, attn_impl=attn_impl,
                               xent_impl=xent_impl, kv_heads=kv_heads,
                               attn_window=attn_window)
    return Workload(
        name=name, cfg=cfg, seq_len=seq,
        global_batch_size=global_batch_size or (8 if test_size else 64),
        loss_fn=moe_lm_loss if moe else lm_loss,
        eval_fn=moe_lm_eval if moe else lm_eval,
        make_optimizer=lambda params: adamw(params, 3e-4, weight_decay=0.1),
        input_fn=lambda ctx, seed: synthetic_lm(
            ctx, vocab_size=cfg.vocab_size, seq_len=seq, seed=seed),
        model_cls=GPTMoELM if moe else GPTLM,
        model_takes_group=moe,
    )
