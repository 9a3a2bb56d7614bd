#!/usr/bin/env python3
"""train_torch.py - train a preset with the PyTorch port.

The twin of ``train.py`` for the presets the port has, on one device or
data-parallel over ranks (``--mesh data=N``, one process per device): the
GPT language models ``gpt_lm``, ``gpt_medium_lm``,
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
    ./run_distributed_torch.sh -n 2 -- --workload gpt_lm --test-size \
        --device cpu --dist-backend gloo --steps 3

Data parallelism: the cluster comes from the environment (torchrun's
``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``, ``TF_CONFIG``,
Slurm, MPI, Kubernetes, GCE or SageMaker; ``parallel.bootstrap``), the
process group's backend from ``--dist-backend`` (NCCL, the default, on
the cards; gloo only where asked for, as on the CPU), and each process
drives ``cuda:<local rank>``.  ``--mesh data=N`` (or a multi-process
cluster without ``--mesh``, which takes ``data=-1``) trains the global
batch ``--batch-size`` as JAX's step over a mesh would: each rank reads
its own input pipeline (seed + rank), holds its share of every
microbatch, and the ranks sum their gradients once a step.  Only the
chief prints and writes ``metrics.jsonl``.  ``--eval-every`` runs on one
process only.

Prints one JSON line per log step: ``step``, ``loss``, ``perplexity``
(the language models), ``step_ms`` (mean wall time of the steps since
the last line, each ending when its loss reaches the host),
``examples_per_sec`` and, where the preset has a sequence length (GPT,
BERT), ``tokens_per_sec``.  With ``--logdir`` it also appends
``metrics.jsonl`` rows with the keys ``train.py``'s trainer writes
(``loss``, the preset's metrics, ``steps_per_sec``,
``examples_per_sec``, ``examples_per_sec_per_chip``; ``eval_*`` with
``--eval-every``), which ``tools/check_metrics_schema.py`` accepts.

Checkpoints (``train.py``'s flags): with ``--checkpoint-dir`` the run
restores the newest verified checkpoint there (logging ``restored
checkpoint step N``), fast-forwards its input past the N batches the
saved run consumed (``fast-forwarding input N batches``) and trains on to
``--steps`` in all, so the same command reruns a cut run to its end.  It
saves every ``--checkpoint-every`` steps (asynchronously) and at the end,
and on SIGTERM saves at the next step boundary and exits with status 0.
``--watchdog-timeout`` dumps every thread's stack when no step ends for
that many seconds; ``--deterministic`` pins the CUDA arithmetic
(``utils.enable_determinism``)::

    python train_torch.py --workload gpt_lm --test-size --device cpu \
        --steps 4 --checkpoint-dir /tmp/ck --checkpoint-every 2
    python train_torch.py --workload gpt_lm --test-size --device cpu \
        --steps 8 --checkpoint-dir /tmp/ck --checkpoint-every 2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import time

import torch

from distributedtensorflow_tpu_torch.checkpoint import (
    CheckpointManager,
    PreemptionHandler,
)
from distributedtensorflow_tpu_torch.data import (
    InputContext,
    current_input_context,
    device_put_batch,
    skip_batches,
)
from distributedtensorflow_tpu_torch.device import resolve_device
from distributedtensorflow_tpu_torch.parallel import bootstrap
from distributedtensorflow_tpu_torch.parallel.mesh import (
    MeshSpec,
    build_mesh,
    parse_mesh,
    replica_count,
)
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
from distributedtensorflow_tpu_torch.utils import (
    MetricWriter,
    ThroughputMeter,
    Watchdog,
    enable_determinism,
)
from distributedtensorflow_tpu_torch.workloads import WORKLOADS, get_workload

logger = logging.getLogger("train_torch")

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
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default=None,
                   help="compute dtype in place of the preset's (fp32 for "
                        "parity checks: in bf16 each rank rounds its own "
                        "rows' gradients)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--eval-every", type=int, default=0)
    p.add_argument("--logdir", default=None,
                   help="append metrics.jsonl rows here")
    p.add_argument("--checkpoint-dir", default=None,
                   help="save here, and resume from the newest verified "
                        "checkpoint here")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save every N steps (0: at the end and on "
                        "preemption only)")
    p.add_argument("--watchdog-timeout", type=float, default=0.0,
                   help="dump all stacks if no step completes for N seconds")
    p.add_argument("--deterministic", action="store_true",
                   help="deterministic CUDA algorithms, cuBLAS workspace "
                        "and cuDNN, TF32 off: a rerun repeats bit for bit")
    p.add_argument("--device", default="cuda")
    p.add_argument("--mesh", default=None,
                   help="mesh axes, e.g. 'data=2' or 'data=-1' (every "
                        "process of the cluster); only the data axis is "
                        "ported")
    p.add_argument("--dist-backend", choices=bootstrap.BACKENDS,
                   default="nccl",
                   help="process-group backend over a mesh: nccl on the "
                        "cards, gloo where asked for (the CPU)")
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


def _device_batches(source, device, mesh=None, accum_steps=1):
    """Numpy batches as device tensors (:func:`device_put_batch`)."""
    for b in source:
        yield device_put_batch(b, device, mesh, accum_steps=accum_steps)


def bootstrap_mesh(args):
    """``(mesh, device)``: without ``--mesh`` and outside a multi-process
    cluster, no mesh and ``--device``; else the process group started
    with ``--dist-backend`` over the resolved cluster, the mesh of
    ``--mesh`` (default ``data=-1``) and this process's device
    (``cuda:<local rank>``)."""
    device = resolve_device(args.device)
    cluster = bootstrap.resolve_cluster()
    spec = parse_mesh(args.mesh)
    if spec is None and not cluster.is_multiprocess:
        return None, device
    if device.type == "cpu" and args.dist_backend == "nccl":
        raise SystemExit("--device cpu over a mesh needs --dist-backend "
                         "gloo (NCCL runs on CUDA devices only)")
    device = bootstrap.local_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    bootstrap.initialize(cluster, backend=args.dist_backend)
    return build_mesh(spec or MeshSpec(data=-1)), device


def build(args: argparse.Namespace, checkpointer=None):
    """``(workload, state, step_fn, batches)`` for ``args``: the model
    from seeded random weights on the device, the optimizer, the train
    step and an iterator of device batches; over a mesh (see
    :func:`bootstrap_mesh`) this rank's state, step and share of each
    batch.  With a ``checkpointer`` (a ``CheckpointManager``) the state
    is its newest verified checkpoint, if it has one, and the batches
    start after the ones the saved run consumed."""
    mesh, device = bootstrap_mesh(args)
    wl = get_workload(
        args.workload, test_size=args.test_size,
        global_batch_size=args.batch_size, seq_len=args.seq_len,
        remat=_REMAT[args.remat], attn_impl=args.attn_impl,
        xent_impl=args.xent_impl, kv_heads=args.kv_heads,
        attn_window=args.attn_window)
    wl = apply_optimizer_flags(wl, args)
    if args.dtype:
        wl = dataclasses.replace(wl, cfg=dataclasses.replace(
            wl.cfg, dtype=getattr(torch, args.dtype)))
    accum = wl.accum_steps if args.accum_steps is None else args.accum_steps
    replicas = 1 if mesh is None else replica_count(mesh)
    if wl.global_batch_size % (replicas * accum):
        raise SystemExit(f"global batch {wl.global_batch_size} not divisible "
                         f"by {replicas} replicas x {accum} microbatches")
    group = {"group": mesh} if mesh is not None else {}
    model = wl.model_cls(wl.cfg, device=device,
                         **(group if wl.model_takes_group else {}))
    model.load_state_dict(
        wl.init_params(wl.cfg, torch.Generator().manual_seed(args.seed)))
    state = TrainState.create(model, wl.make_optimizer, mesh)
    if checkpointer is not None:
        checkpointer.restore_latest(state)
    step = make_train_step(wl.loss_fn(model, **group), accum_steps=accum,
                           seed=args.seed, mesh=mesh)
    ctx = current_input_context(wl.global_batch_size, mesh)
    source = wl.input_fn(ctx, args.seed)
    if state.step:
        logger.info("fast-forwarding input %d batches", state.step)
        source = skip_batches(source, state.step)
    batches = _device_batches(source, device, mesh, accum)
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
    """Train; returns the records (the chief prints them).  A process
    group this call started is shut down at its end."""
    args = parse_args(argv)
    started = not torch.distributed.is_initialized()
    try:
        return _train(args)
    finally:
        if started:
            bootstrap.shutdown()


def _train(args) -> list[dict]:
    if args.deterministic:
        enable_determinism()  # before the first cuBLAS call
    checkpointer = CheckpointManager(args.checkpoint_dir) \
        if args.checkpoint_dir else None
    wl, state, step, batches = build(args, checkpointer)
    chief = bootstrap.is_chief()
    if args.eval_every and bootstrap.process_count() > 1:
        raise SystemExit("--eval-every over more than one process is not "
                         "ported")
    # SIGTERM (a preemption notice) -> a save at the next step boundary on
    # every rank, then a clean stop; the rerun resumes from that step
    preemption = PreemptionHandler(checkpointer) if checkpointer else None
    watchdog = Watchdog(args.watchdog_timeout) if args.watchdog_timeout \
        else None
    records, times = [], []
    meter = ThroughputMeter(wl.global_batch_size)
    try:
        with MetricWriter(args.logdir) as writer:
            meter.start()
            while state.step < args.steps:
                batch = next(batches)
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                loss = float(metrics["loss"])  # waits for the step to end
                times.append(time.perf_counter() - t0)
                meter.update()
                if watchdog is not None:
                    watchdog.ping()
                if state.step % args.log_every == 0 \
                        or state.step == args.steps:
                    step_s = sum(times) / len(times)
                    rec = {"step": state.step, "loss": loss}
                    if "perplexity" in metrics:
                        rec["perplexity"] = float(metrics["perplexity"])
                    rec["step_ms"] = 1e3 * step_s
                    rec["examples_per_sec"] = wl.global_batch_size / step_s
                    if wl.seq_len:
                        rec["tokens_per_sec"] = (wl.global_batch_size
                                                 * wl.seq_len / step_s)
                    if chief:
                        print(json.dumps(rec), flush=True)
                    records.append(rec)
                    writer.write(state.step, {
                        **{k: float(v) for k, v in metrics.items()},
                        **meter.rates()})
                    times = []
                    meter.start()
                if args.eval_every and state.step % args.eval_every == 0:
                    writer.write(state.step, {
                        f"eval_{k}": v
                        for k, v in evaluate(wl, state, args).items()})
                if checkpointer is not None and args.checkpoint_every \
                        and state.step % args.checkpoint_every == 0:
                    checkpointer.save(state.step, state)
                if preemption is not None \
                        and preemption.should_save(state.step):
                    preemption.save_and_exit(state.step, state)
                    return records
        if checkpointer is not None:
            checkpointer.save(state.step, state, force=True)
            checkpointer.wait()
    finally:
        if watchdog is not None:
            watchdog.stop()
        if preemption is not None:
            preemption.uninstall()
    return records


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    main(sys.argv[1:])
