#!/usr/bin/env python3
"""train_torch.py - train a preset with the PyTorch port.

The twin of ``train.py`` for the presets the port has, on one device:
the GPT language models ``gpt_lm``, ``gpt_medium_lm``,
``lm_long_context`` and ``gpt_moe``, and the BASELINE.json workloads
``mnist_lenet``, ``cifar_resnet20``, ``imagenet_resnet50``, ``bert_mlm``,
``bert_mlm_packed`` and ``widedeep``.  Synthetic batches, the preset's
optimizer or the one that ``--optimizer/--lr/--schedule/--warmup-steps/
--weight-decay/--clipnorm/--decay-mask`` build (the same flags, defaults
and checks as ``train.py``), the preset's gradient accumulation unless
``--accum-steps`` says otherwise.  On the card the GPT head is the fused
one (kernels K4f/K4b) unless ``--xent-impl`` says otherwise.  Runs on the
CUDA card unless ``--device cpu`` is given:

    python train_torch.py --workload gpt_lm --steps 20
    python train_torch.py --workload gpt_lm --test-size --device cpu --steps 3
    python train_torch.py --workload imagenet_resnet50 --steps 20
    python train_torch.py --workload bert_mlm --test-size --device cpu \
        --steps 3 --batch-size 8

Prints one JSON line per log step: ``step``, ``loss``, ``perplexity``
(the language models), ``step_ms`` (mean wall time of the steps since
the last line, each ending when its loss reaches the host),
``examples_per_sec`` and, where the preset has a sequence length (GPT,
BERT), ``tokens_per_sec``.  With ``--logdir`` it also appends
``metrics.jsonl`` rows with the keys ``train.py``'s trainer writes
(``loss``, the preset's metrics, ``steps_per_sec``,
``examples_per_sec``, ``examples_per_sec_per_chip``; ``eval_*`` with
``--eval-every``), which ``tools/check_metrics_schema.py`` accepts.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from distributedtensorflow_tpu_torch.data import InputContext
from distributedtensorflow_tpu_torch.device import resolve_device
from distributedtensorflow_tpu_torch.train import (
    TrainState,
    make_eval_step,
    make_train_step,
)
from distributedtensorflow_tpu_torch.train.optimizers import (
    OPTIMIZERS,
    SCHEDULES,
    build_optimizer,
    build_schedule,
    exclude_bias_and_norm_mask,
)
from distributedtensorflow_tpu_torch.utils import MetricWriter, ThroughputMeter
from distributedtensorflow_tpu_torch.workloads import WORKLOADS, get_workload

_REMAT = {"on": True, "off": False, "attn": "attn", None: None}
#: Eval batches per evaluation (``TrainerConfig.eval_steps`` for the
#: synthetic sources, ``train.py:298``).
EVAL_STEPS = 10


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="gpt_lm", choices=WORKLOADS)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=None,
                   help="global batch size (default: workload preset)")
    p.add_argument("--accum-steps", type=int, default=None,
                   help="microbatches a step (default: workload preset)")
    p.add_argument("--seq-len", type=int, default=None)
    p.add_argument("--optimizer", default=None, choices=OPTIMIZERS,
                   help="override the preset's optimizer (requires --lr)")
    p.add_argument("--lr", type=float, default=None,
                   help="peak learning rate for --optimizer")
    p.add_argument("--schedule", choices=SCHEDULES, default="constant",
                   help="LR schedule for --optimizer (decay over --steps)")
    p.add_argument("--warmup-steps", type=int, default=0,
                   help="linear LR warmup steps for --optimizer")
    p.add_argument("--decay-mask", choices=("none", "bias-norm"),
                   default="none",
                   help="scope --weight-decay: bias-norm = skip biases and"
                        " norm scales")
    p.add_argument("--clipnorm", type=float, default=0.0,
                   help="clip gradients by global norm before the optimizer")
    p.add_argument("--weight-decay", type=float, default=0.0,
                   help="weight decay for --optimizer (adamw)")
    p.add_argument("--remat", choices=("on", "off", "attn"), default=None,
                   help="recompute whole blocks (on), nothing (off) or the "
                        "attention op only (attn) in the backward")
    p.add_argument("--attn-impl", choices=("auto", "xla", "pallas"),
                   default=None,
                   help="auto = the flash kernels on the card past the seq "
                        "gate; pallas = always the flash kernels")
    p.add_argument("--xent-impl",
                   choices=("auto", "chunked", "chunked_bf16", "fused"),
                   default=None,
                   help="head loss: auto = fused on the card (kernels "
                        "K4f/K4b), chunked on the CPU")
    p.add_argument("--kv-heads", type=int, default=None)
    p.add_argument("--attn-window", type=int, default=None)
    p.add_argument("--test-size", action="store_true",
                   help="shrink the model (the JAX test sizes: gpt_tiny or "
                        "gpt_moe_tiny at seq 64, bert_tiny at seq 128, "
                        "ResNet-50 at 64x64, widedeep_test_config)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--eval-every", type=int, default=0)
    p.add_argument("--logdir", default=None,
                   help="append metrics.jsonl rows here")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def apply_optimizer_flags(wl, args):
    """--optimizer/--lr/--schedule override the preset's optimizer, with
    ``train.py``'s checks (``apply_optimizer_flags``, ``:125-195``)."""
    if not args.optimizer:
        if args.lr is not None:
            raise SystemExit("--lr requires --optimizer (which family to "
                             "build)")
        if (args.schedule != "constant" or args.warmup_steps
                or args.weight_decay or args.clipnorm
                or args.decay_mask != "none"):
            raise SystemExit(
                "--schedule/--warmup-steps/--weight-decay/--clipnorm/"
                "--decay-mask require --optimizer (they parameterize the "
                "override, not the preset's own optimizer)")
        return wl
    if args.lr is None:
        raise SystemExit("--optimizer requires --lr")
    if args.decay_mask == "bias-norm" and not args.weight_decay:
        raise SystemExit("--decay-mask requires --weight-decay > 0")
    mask = (exclude_bias_and_norm_mask if args.decay_mask == "bias-norm"
            else None)
    try:
        lr = build_schedule(args.schedule, args.lr,
                            warmup_steps=args.warmup_steps,
                            total_steps=args.steps)
        make = build_optimizer(args.optimizer, lr,
                               weight_decay=args.weight_decay,
                               global_clipnorm=args.clipnorm,
                               decay_mask=mask)
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(str(e)) from None
    return dataclasses.replace(wl, make_optimizer=make)


def _device_batches(source, device):
    """Numpy batches as device tensors: integer leaves (ids, labels,
    segments) as ``torch.long``, float leaves (NHWC images, dense
    features) in their own dtype."""
    for b in source:
        yield {k: torch.as_tensor(v, device=device,
                                  dtype=torch.long if v.dtype.kind in "iu"
                                  else None)
               for k, v in b.items()}


def build(args: argparse.Namespace):
    """``(workload, state, step_fn, batches)`` for ``args``: the model
    from seeded random weights on the device, the optimizer, the train
    step and an iterator of device batches."""
    device = resolve_device(args.device)
    wl = get_workload(
        args.workload, test_size=args.test_size,
        global_batch_size=args.batch_size, seq_len=args.seq_len,
        remat=_REMAT[args.remat], attn_impl=args.attn_impl,
        xent_impl=args.xent_impl, kv_heads=args.kv_heads,
        attn_window=args.attn_window)
    wl = apply_optimizer_flags(wl, args)
    model = wl.model_cls(wl.cfg, device=device)
    model.load_state_dict(
        wl.init_params(wl.cfg, torch.Generator().manual_seed(args.seed)))
    state = TrainState(0, model,
                       wl.make_optimizer(list(model.named_parameters())))
    accum = wl.accum_steps if args.accum_steps is None else args.accum_steps
    step = make_train_step(wl.loss_fn(model), accum_steps=accum,
                           seed=args.seed)
    ctx = InputContext(global_batch_size=wl.global_batch_size)
    batches = _device_batches(wl.input_fn(ctx, args.seed), device)
    return wl, state, step, batches


def evaluate(wl, state, args) -> dict[str, float]:
    """Mean of the eval metrics over :data:`EVAL_STEPS` batches of the
    eval stream (seed + 999, as ``train.py`` draws it)."""
    eval_step = make_eval_step(wl.eval_fn(state.model))
    ctx = InputContext(global_batch_size=wl.global_batch_size)
    source = _device_batches(wl.input_fn(ctx, args.seed + 999),
                             state.model.device)
    sums: dict[str, float] = {}
    for _ in range(EVAL_STEPS):
        for k, v in eval_step(state, next(source)).items():
            sums[k] = sums.get(k, 0.0) + float(v)
    return {k: v / EVAL_STEPS for k, v in sums.items()}


def main(argv=None) -> list[dict]:
    """Train; returns the printed records."""
    args = parse_args(argv)
    wl, state, step, batches = build(args)
    records, times = [], []
    meter = ThroughputMeter(wl.global_batch_size)
    with MetricWriter(args.logdir) as writer:
        meter.start()
        for i in range(args.steps):
            batch = next(batches)
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            loss = float(metrics["loss"])  # waits for the step to finish
            times.append(time.perf_counter() - t0)
            meter.update()
            if (i + 1) % args.log_every == 0 or i + 1 == args.steps:
                step_s = sum(times) / len(times)
                rec = {"step": state.step, "loss": loss}
                if "perplexity" in metrics:
                    rec["perplexity"] = float(metrics["perplexity"])
                rec["step_ms"] = 1e3 * step_s
                rec["examples_per_sec"] = wl.global_batch_size / step_s
                if wl.seq_len:
                    rec["tokens_per_sec"] = (wl.global_batch_size
                                             * wl.seq_len / step_s)
                print(json.dumps(rec), flush=True)
                records.append(rec)
                writer.write(state.step, {
                    **{k: float(v) for k, v in metrics.items()},
                    **meter.rates()})
                times = []
                meter.start()
            if args.eval_every and (i + 1) % args.eval_every == 0:
                writer.write(state.step, {
                    f"eval_{k}": v
                    for k, v in evaluate(wl, state, args).items()})
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
