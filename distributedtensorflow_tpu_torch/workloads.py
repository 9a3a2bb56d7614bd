"""Training presets of the port: the GPT language-model family.

Twin of ``distributedtensorflow_tpu/workloads.py`` for ``gpt_lm``,
``gpt_medium_lm``, ``lm_long_context`` (``:403-510``) and ``gpt_moe``
(``:566-612``), with the same defaults: GPT-2-small (or -medium, or
GPT-2-small with eight experts on every second block) at seq 2048,
global batch 64, AdamW at 3e-4 with weight decay 0.1, synthetic
next-token batches; ``lm_long_context`` is GPT-2-small at seq 8192 with
attention-only remat and the flash kernels forced; ``test_size`` gives
``gpt_tiny`` (``gpt_moe_tiny``) at seq 64, batch 8.
:func:`synthetic_lm` is a copy of the JAX package's numpy source with
the same seeds, so both packages see identical batches.  The other
presets, the meshes and the pipeline/sequence/expert-parallel variants
are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import numpy as np

from .data import InputContext
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
from .train.optimizers import adamw


#: The presets the port has.
WORKLOADS = ("gpt_lm", "gpt_medium_lm", "lm_long_context", "gpt_moe")


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


@dataclasses.dataclass
class Workload:
    name: str
    cfg: GPTConfig
    seq_len: int
    global_batch_size: int
    #: model -> ``loss_fn(batch, generator) -> (loss, metrics)``
    loss_fn: Callable[[GPTLM], Callable]
    #: model -> ``metric_fn(batch) -> metrics``
    eval_fn: Callable[[GPTLM], Callable]
    #: parameters -> optimizer
    make_optimizer: Callable
    #: ``(ctx, seed) -> iterator of numpy batches``
    input_fn: Callable[[InputContext, int], Iterator[dict]]
    accum_steps: int = 1
    #: ``(cfg, device=...) -> model``
    model_cls: Callable = GPTLM
    #: ``(cfg, generator) -> state_dict`` of seeded weights
    init_params: Callable = init_params


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
    """Build a ported preset by name; ``test_size`` shrinks the model."""
    if name not in WORKLOADS:
        raise ValueError(f"workload {name!r} is not ported; the port has "
                         f"{', '.join(WORKLOADS)}")
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
    )
