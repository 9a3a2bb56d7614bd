#!/usr/bin/env python3
"""train_torch.py - train a GPT language-model preset with the PyTorch port.

The twin of ``train.py`` for the path the port has: the ``gpt_lm`` and
``gpt_medium_lm`` presets on one device, AdamW, synthetic next-token
batches.  Runs on the CUDA card unless ``--device cpu`` is given:

    python train_torch.py --workload gpt_lm --steps 20
    python train_torch.py --workload gpt_lm --test-size --device cpu --steps 3

Prints one JSON line per log step: ``step``, ``loss``, ``perplexity``,
``step_ms`` (mean wall time of the steps since the last line, each
ending when its loss reaches the host) and ``tokens_per_sec``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from distributedtensorflow_tpu_torch.data import InputContext
from distributedtensorflow_tpu_torch.device import resolve_device
from distributedtensorflow_tpu_torch.models import GPTLM, init_params
from distributedtensorflow_tpu_torch.train import TrainState, make_train_step
from distributedtensorflow_tpu_torch.workloads import get_workload

_REMAT = {"on": True, "off": False, "attn": "attn", None: None}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="gpt_lm",
                   choices=("gpt_lm", "gpt_medium_lm"))
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=None,
                   help="global batch size (default: workload preset)")
    p.add_argument("--accum-steps", type=int, default=1)
    p.add_argument("--seq-len", type=int, default=None)
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
                   help="head loss (fused is not ported yet; auto = chunked)")
    p.add_argument("--kv-heads", type=int, default=None)
    p.add_argument("--attn-window", type=int, default=None)
    p.add_argument("--test-size", action="store_true",
                   help="shrink the model (gpt_tiny at seq 64)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def build(args: argparse.Namespace):
    """``(workload, state, step_fn, batches)`` for ``args``: the model
    from seeded random weights on the device, AdamW, the train step and
    an iterator of device batches."""
    device = resolve_device(args.device)
    wl = get_workload(
        args.workload, test_size=args.test_size,
        global_batch_size=args.batch_size, seq_len=args.seq_len,
        remat=_REMAT[args.remat], attn_impl=args.attn_impl,
        xent_impl=args.xent_impl, kv_heads=args.kv_heads,
        attn_window=args.attn_window)
    model = GPTLM(wl.cfg, device=device)
    model.load_state_dict(
        init_params(wl.cfg, torch.Generator().manual_seed(args.seed)))
    state = TrainState(0, model, wl.make_optimizer(model.parameters()))
    step = make_train_step(wl.loss_fn(model), accum_steps=args.accum_steps,
                           seed=args.seed)
    source = wl.input_fn(
        InputContext(global_batch_size=wl.global_batch_size), args.seed)
    batches = ({k: torch.as_tensor(v, dtype=torch.long, device=device)
                for k, v in b.items()} for b in source)
    return wl, state, step, batches


def main(argv=None) -> list[dict]:
    """Train; returns the printed records."""
    args = parse_args(argv)
    wl, state, step, batches = build(args)
    tokens = wl.global_batch_size * wl.seq_len
    records, times = [], []
    for i in range(args.steps):
        batch = next(batches)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])  # waits for the step to finish
        times.append(time.perf_counter() - t0)
        if (i + 1) % args.log_every == 0 or i + 1 == args.steps:
            step_s = sum(times) / len(times)
            rec = {"step": state.step, "loss": loss,
                   "perplexity": float(metrics["perplexity"]),
                   "step_ms": 1e3 * step_s,
                   "tokens_per_sec": tokens / step_s}
            print(json.dumps(rec), flush=True)
            records.append(rec)
            times = []
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
