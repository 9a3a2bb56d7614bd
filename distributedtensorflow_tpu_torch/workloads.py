"""Training presets of the port: the GPT language-model family, the
five BASELINE.json workloads, the ViT and the seq2seq encoder-decoder.

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
- ``bert_moe`` (``:511-563``): BERT-base with eight experts on every
  second block, routed by expert choice, on ``bert_mlm``'s task, batch,
  accumulation and optimizer; ``bert_moe_tiny`` at seq 128 at test size.
- ``imagenet_vit`` (``:303-326``): ViT-S/16 at 224x224, global batch
  1024, AdamW with weight decay 0.05 on a warm-up cosine schedule (peak
  3e-3, 1563 warm-up steps of 93750), top-5 in eval; ``vit_tiny`` at
  test size.
- ``t5_seq2seq`` (``:613-653``): ``seq2seq_small`` (hidden 512, 6+6
  layers, vocab 32128) at seq 256, global batch 64, AdamW at 3e-4 with
  weight decay 0.1, synthetic copy-task batches; ``seq2seq_tiny`` at seq
  32, batch 8 at test size.  ``seq_len`` grows ``max_seq`` where it
  passes it and ``kv_heads`` sets the K/V heads, as in JAX.

The synthetic sources are copies of the JAX package's numpy sources
with the same seeds, so both packages see identical batches; over a
data-parallel mesh each rank's source is seeded by ``seed +
input_pipeline_id``, as each JAX host's is.  Each preset carries its
``model``-axis layout (``layout``: GPT, BERT, ViT, seq2seq and
Wide&Deep; the MoE presets' add the expert stacks over ``expert``), and
``quant`` switches the transformer presets' block matmuls
(:data:`QUANTIZABLE`).  ``for_mesh`` runs the preset's ``finalize``, as
JAX's does (``workloads.py:441-509,535-564,587-598``): over a ``seq``
axis the GPT LMs take ring or Ulysses attention (``sp_scheme``,
:data:`SEQ_PARALLEL`), over an ``expert`` axis the MoE presets the
all-to-all expert region; over a ``pipe`` axis the GPT LMs become the
pipeline-parallel ``models.gpt_pipeline.PipelinedGPT`` (``pp_virtual``
chunks a stage, ``pp_schedule``, ``pp_handoff``; JAX's
``workloads.py:441-478``), composing with ``model`` and, for GPipe, with
``seq``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Iterator

import numpy as np
import torch

from .data import InputContext, pack_sequences, synthetic_classification
from .models.bert import (
    BertForMLM,
    bert_base,
    bert_layout,
    bert_tiny,
    max_predictions_for,
    mlm_eval,
    mlm_loss,
)
from .models.bert_moe import (
    BertMoEForMLM,
    bert_moe_base,
    bert_moe_layout,
    bert_moe_tiny,
    bind_expert_parallel_bert,
    moe_mlm_loss,
)
from .models.convert import init_params, pipeline_state
from .models.gpt import (
    GPT_BLOCK_RULES,
    GPTConfig,
    GPTLM,
    gpt_layout,
    gpt_medium,
    gpt_small,
    gpt_tiny,
    lm_eval,
    lm_loss,
)
from .models.gpt_pipeline import (
    PipelinedGPT,
    pipelined_lm_eval,
    pipelined_lm_loss,
)
from .models.gpt_moe import (
    GPTMoELM,
    bind_expert_parallel,
    gpt_moe_layout,
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
from .models.seq2seq import (
    Seq2SeqLM,
    seq2seq_eval,
    seq2seq_layout,
    seq2seq_loss,
    seq2seq_small,
    seq2seq_tiny,
)
from .models.vit import ViT, vit_layout, vit_s16, vit_tiny
from .models.widedeep import (
    WideDeep,
    WideDeepConfig,
    widedeep_eval,
    widedeep_layout,
    widedeep_loss,
    widedeep_test_config,
)
from .parallel.pipeline import SCHEDULES
from .parallel.ring_attention import SCHEMES, sequence_parallel_attention_fn
from .parallel.sharding import LayoutMap
from .train.losses import classification_eval, classification_loss
from .train.optimizers import (
    adagrad,
    adamw,
    build_optimizer,
    sgd,
    warmup_cosine_decay_schedule,
)

#: The presets the port has, in the JAX package's order.
WORKLOADS = ("mnist_lenet", "cifar_resnet20", "imagenet_resnet50",
             "imagenet_vit", "bert_mlm", "bert_mlm_packed", "bert_moe",
             "widedeep", "gpt_lm", "gpt_medium_lm", "lm_long_context",
             "gpt_moe", "t5_seq2seq")
#: The presets that split the sequence over a ``seq`` axis and their
#: blocks over a ``pipe`` axis (JAX's ``finalize`` of the GPT LMs); the
#: others refuse both.
SEQ_PARALLEL = ("gpt_lm", "gpt_medium_lm", "lm_long_context")


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


def synthetic_seq2seq(ctx: InputContext, *, vocab_size: int, seq_len: int,
                      pad_id: int, seed: int = 0) -> Iterator[dict]:
    """Synthetic copy-task batches for the encoder-decoder preset: the
    targets are the encoder stream itself with a random-length pad tail
    (learnable only through cross-attention); ids avoid ``pad_id``."""
    rng = np.random.default_rng(seed + ctx.input_pipeline_id)
    n = ctx.per_host_batch_size
    while True:
        ids = rng.integers(2, vocab_size, size=(n, seq_len))
        lengths = rng.integers(seq_len // 2, seq_len + 1, size=(n, 1))
        keep = np.arange(seq_len) < lengths
        ids = np.where(keep, ids, pad_id).astype(np.int32)
        yield {"encoder_ids": ids, "targets": ids.copy()}


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
    #: tokens a row (the LM, MLM and seq2seq presets), else None
    seq_len: int | None
    global_batch_size: int
    #: ``(model, group=None) -> loss_fn(batch, generator) -> (loss,
    #: metrics)``; with a data-parallel group (or mesh) the loss and
    #: metrics are this rank's shares (``train.engine``)
    loss_fn: Callable[..., Callable]
    #: ``(model, group=None) -> metric_fn(batch) -> metrics``; with a
    #: data-parallel group (or mesh) the metrics are this rank's shares
    #: (``train.engine.make_eval_step``)
    eval_fn: Callable[..., Callable]
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
    #: the ``model``- and ``expert``-axis rules
    #: (``parallel.sharding.LayoutMap``), None: every parameter replicated
    layout: LayoutMap | None = None
    #: ``(workload, mesh) -> workload``: the preset bound to a mesh (JAX's
    #: ``finalize``), None: the same for every mesh
    finalize: Callable | None = None

    def for_mesh(self, mesh) -> "Workload":
        """The workload bound to ``mesh`` (JAX ``Workload.for_mesh``): its
        ``finalize``.  A ``seq`` axis larger than 1 is refused by the
        presets that do not split the sequence (JAX runs them replicated
        over it)."""
        if mesh is None:
            return self
        for axis, what in (("seq", "sequence"), ("pipe", "pipeline")):
            if mesh.shape[axis] > 1 and self.name not in SEQ_PARALLEL:
                raise NotImplementedError(
                    f"{self.name} over a {axis} axis is not ported: {what} "
                    f"parallelism is ported for {', '.join(SEQ_PARALLEL)}")
        return self.finalize(self, mesh) if self.finalize else self


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
            eval_fn=lambda m, group=None: classification_eval(
                m, top5=True, group=group),
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
            eval_fn=lambda m, group=None: mlm_eval(m, max_predictions=p,
                                                   group=group),
            make_optimizer=lambda params: adamw(params, 1e-4,
                                                weight_decay=0.01),
            input_fn=lambda ctx, seed: source(
                ctx, vocab_size=cfg.vocab_size, seq_len=seq, seed=seed),
            accum_steps=4, model_cls=BertForMLM, layout=bert_layout())
    if name == "bert_moe":
        cfg = bert_moe_tiny() if test_size else bert_moe_base()
        seq = seq_len or (128 if test_size else 512)
        if seq > cfg.max_position:
            cfg = dataclasses.replace(cfg, max_position=seq)
        p = max_predictions_for(seq)
        return Workload(
            name=name, cfg=cfg, seq_len=seq,
            global_batch_size=global_batch_size or 256,
            loss_fn=lambda m, group=None: moe_mlm_loss(
                m, max_predictions=p, group=group),
            eval_fn=lambda m, group=None: mlm_eval(m, max_predictions=p,
                                                   group=group),
            make_optimizer=lambda params: adamw(params, 1e-4,
                                                weight_decay=0.01),
            input_fn=lambda ctx, seed: synthetic_mlm(
                ctx, vocab_size=cfg.vocab_size, seq_len=seq, seed=seed),
            accum_steps=4, model_cls=BertMoEForMLM, model_takes_group=True,
            layout=bert_moe_layout(),
            finalize=_expert_finalize(bind_expert_parallel_bert))
    cfg = widedeep_test_config() if test_size else WideDeepConfig()
    return Workload(
        name=name, cfg=cfg, seq_len=None,
        global_batch_size=global_batch_size or 4096,
        loss_fn=widedeep_loss, eval_fn=widedeep_eval,
        make_optimizer=lambda params: adagrad(params, 0.01),
        input_fn=lambda ctx, seed: synthetic_recsys(ctx, cfg, seed),
        model_cls=WideDeep, layout=widedeep_layout())


def _vit(*, test_size: bool, global_batch_size: int | None) -> Workload:
    """``imagenet_vit`` (``workloads.py:303-326``)."""
    cfg = vit_tiny() if test_size else vit_s16()
    return Workload(
        name="imagenet_vit", cfg=cfg, seq_len=None,
        global_batch_size=global_batch_size or 1024,
        loss_fn=classification_loss,
        eval_fn=lambda m, group=None: classification_eval(
            m, top5=not test_size, group=group),
        make_optimizer=build_optimizer(
            "adamw", warmup_cosine_decay_schedule(0.0, 3e-3, 1563, 93_750),
            weight_decay=0.05),
        input_fn=_image_input((cfg.image_size, cfg.image_size, 3),
                              cfg.num_classes),
        model_cls=ViT, layout=vit_layout())


def _seq2seq(*, test_size: bool, global_batch_size: int | None,
             seq_len: int | None, kv_heads: int | None) -> Workload:
    """``t5_seq2seq`` (``workloads.py:613-653``)."""
    cfg = seq2seq_tiny() if test_size else seq2seq_small()
    seq = seq_len or (32 if test_size else 256)
    if seq > cfg.max_seq:  # grow the declared envelope with overrides
        cfg = dataclasses.replace(cfg, max_seq=seq)
    if kv_heads is not None:
        cfg = dataclasses.replace(cfg, num_kv_heads=kv_heads)
    return Workload(
        name="t5_seq2seq", cfg=cfg, seq_len=seq,
        global_batch_size=global_batch_size or (8 if test_size else 64),
        loss_fn=seq2seq_loss, eval_fn=seq2seq_eval,
        make_optimizer=lambda params: adamw(params, 3e-4, weight_decay=0.1),
        input_fn=lambda ctx, seed: synthetic_seq2seq(
            ctx, vocab_size=cfg.vocab_size, seq_len=seq, pad_id=cfg.pad_id,
            seed=seed),
        model_cls=Seq2SeqLM, layout=seq2seq_layout(cfg))


def _expert_finalize(bind):
    """The MoE presets' ``finalize``: over an ``expert`` axis larger than
    1 the model is built by ``bind`` (``models.gpt_moe.
    bind_expert_parallel`` or ``models.bert_moe.
    bind_expert_parallel_bert``) with the mesh's all-to-all region."""

    def finalize(wl: Workload, mesh) -> Workload:
        if mesh.shape["expert"] <= 1:
            return wl
        return dataclasses.replace(
            wl, model_cls=functools.partial(bind, mesh=mesh))

    return finalize


def _seq_finalize(sp_scheme: str):
    """The GPT LMs' ``finalize``: over a ``seq`` axis larger than 1 the
    model's attention is ring or Ulysses attention over it
    (``parallel.ring_attention``), and its losses take this rank's slice
    of the sequence (``models.gpt``)."""

    def finalize(wl: Workload, mesh) -> Workload:
        if mesh.shape["seq"] <= 1:
            return wl
        attn = sequence_parallel_attention_fn(mesh, scheme=sp_scheme,
                                              causal=True)
        return dataclasses.replace(
            wl, model_cls=functools.partial(GPTLM, attn_fn=attn))

    return finalize


def pipeline_microbatches(global_batch_size: int, shape: dict,
                          schedule: str) -> int:
    """The pipeline's microbatch count (``workloads.py:455-466``): 4 a
    stage, halved until it divides the replica's batch; for the
    interleaved schedule then stepped down to a multiple of the stages
    that divides it."""
    n = shape["pipe"]
    n_micro = 4 * n
    local_batch = global_batch_size // max(1, shape["data"] * shape["fsdp"])
    while n_micro > 1 and local_batch % n_micro:
        n_micro //= 2
    if schedule == "interleaved":
        while n_micro > n and (n_micro % n or local_batch % n_micro):
            n_micro -= 1
    return n_micro


def _lm_finalize(sp_scheme: str, pp_virtual: int, pp_schedule: str,
                 pp_handoff: str | None):
    """The GPT LMs' ``finalize``: over a ``pipe`` axis larger than 1 the
    pipelined model of this rank's stage (its microbatches by
    :func:`pipeline_microbatches`; ``seq`` inside its stages), else over a
    ``seq`` axis the dense model with ring or Ulysses attention
    (:func:`_seq_finalize`).  The pipelined model's layout is the
    blocks' rules alone: the table stays whole on every rank (JAX's
    pipeline layout places it over ``pipe``, never over ``model``)."""
    seq = _seq_finalize(sp_scheme)

    def finalize(wl: Workload, mesh) -> Workload:
        if mesh.shape["pipe"] <= 1:
            return seq(wl, mesh)
        n_micro = pipeline_microbatches(wl.global_batch_size, mesh.shape,
                                        pp_schedule)
        stage = dict(stage=mesh.coords["pipe"], n_stages=mesh.shape["pipe"],
                     n_virtual=pp_virtual)
        init = wl.init_params
        return dataclasses.replace(
            wl, model_cls=functools.partial(
                PipelinedGPT, mesh=mesh, n_microbatches=n_micro,
                n_virtual=pp_virtual, schedule=pp_schedule,
                sp_scheme=sp_scheme, handoff_dtype=pp_handoff),
            init_params=lambda cfg, generator: pipeline_state(
                init(cfg, generator), cfg, **stage),
            loss_fn=pipelined_lm_loss, eval_fn=pipelined_lm_eval,
            layout=LayoutMap(GPT_BLOCK_RULES))

    return finalize


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


#: The presets with a quantised-compute path (JAX ``get_workload``'s
#: ``quantizable``, ``workloads.py:250-251``): the MoE presets' experts
#: sit outside the dense picker, the conv and recsys presets have no
#: dense trunk.
QUANTIZABLE = ("gpt_lm", "gpt_medium_lm", "lm_long_context", "bert_mlm",
               "bert_mlm_packed", "imagenet_vit")


def get_workload(name: str, *, test_size: bool = False,
                 global_batch_size: int | None = None,
                 sp_scheme: str = "ring",
                 seq_len: int | None = None,
                 remat: bool | str | None = None,
                 attn_impl: str | None = None,
                 xent_impl: str | None = None,
                 kv_heads: int | None = None,
                 attn_window: int | None = None,
                 quant: str | None = None,
                 pp_virtual: int = 1,
                 pp_handoff: str | None = None,
                 pp_schedule: str = "gpipe") -> Workload:
    """Build a ported preset by name; ``test_size`` shrinks the model.
    The GPT knobs (``remat`` ... ``attn_window``) apply to the GPT family
    only, as in JAX, but for ``kv_heads``, which ``t5_seq2seq`` takes
    too.  ``quant`` ("int8", "int8_stochastic", "fp8") runs the block
    matmuls of the presets of :data:`QUANTIZABLE` quantised, and is
    refused for the others.  ``sp_scheme`` ("ring" or "ulysses") is the
    sequence-parallel attention of the GPT LMs over a ``seq`` axis;
    ``pp_virtual``, ``pp_schedule`` and ``pp_handoff`` (None or
    "bfloat16") their pipeline over a ``pipe`` axis."""
    if sp_scheme not in SCHEMES:
        raise ValueError(f"sp_scheme={sp_scheme!r}: expected one of "
                         f"{list(SCHEMES)}")
    if pp_schedule not in SCHEDULES:
        raise ValueError(f"pp_schedule={pp_schedule!r}: expected one of "
                         f"{list(SCHEDULES)}")
    if name not in WORKLOADS:
        raise ValueError(f"workload {name!r} is not ported; the port has "
                         f"{', '.join(WORKLOADS)}")
    if quant and quant != "none" and name not in QUANTIZABLE:
        raise ValueError(
            f"workload {name!r} has no quantized-compute path; "
            f"quant={quant!r} is supported for: {', '.join(QUANTIZABLE)}")
    wl = _workload(name, test_size=test_size,
                   global_batch_size=global_batch_size, seq_len=seq_len,
                   remat=remat, attn_impl=attn_impl, xent_impl=xent_impl,
                   kv_heads=kv_heads, attn_window=attn_window)
    if name in SEQ_PARALLEL:
        wl = dataclasses.replace(wl, finalize=_lm_finalize(
            sp_scheme, pp_virtual, pp_schedule, pp_handoff))
    cfg = wl.cfg
    if quant and quant != "none":
        cfg = dataclasses.replace(cfg, quant=quant)
    return dataclasses.replace(wl, cfg=cfg)


def _workload(name: str, *, test_size, global_batch_size, seq_len, remat,
              attn_impl, xent_impl, kv_heads, attn_window) -> Workload:
    if name == "imagenet_vit":
        return _vit(test_size=test_size, global_batch_size=global_batch_size)
    if name == "t5_seq2seq":
        return _seq2seq(test_size=test_size,
                        global_batch_size=global_batch_size,
                        seq_len=seq_len, kv_heads=kv_heads)
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
        layout=gpt_moe_layout() if moe else gpt_layout(),
        finalize=_expert_finalize(bind_expert_parallel) if moe else None,
    )
