#!/usr/bin/env python3
"""train_torch.py - train a preset with the PyTorch port.

The twin of ``train.py`` for the presets the port has, on one device or
data-parallel over ranks (``--mesh data=N``, one process per device): the
GPT language models ``gpt_lm``, ``gpt_medium_lm``,
``lm_long_context`` and ``gpt_moe``, the BASELINE.json workloads
``mnist_lenet`` (the default), ``cifar_resnet20``, ``imagenet_resnet50``,
``bert_mlm``, ``bert_mlm_packed`` and ``widedeep``, the BERT-MoE encoder
``bert_moe`` (expert-choice routing), the ViT-S/16 classifier
``imagenet_vit`` and the encoder-decoder ``t5_seq2seq`` (``--seq-len``
and ``--kv-heads`` as in ``train.py``).  Synthetic batches, the preset's
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
    python train_torch.py --workload t5_seq2seq --test-size --device cpu \
        --steps 3 --kv-heads 2
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
chief prints and writes ``metrics.jsonl``.  ``--eval-every`` evaluates
over the ranks as well: each reads its share of the global eval batch
and the metrics are the global batch's.

The loop is ``train.Trainer.fit``, as ``train.py``'s: the host runs ahead
of the card and reads the step's metrics back at log steps only (a log
step is a multiple of ``--log-every``, or the last step).  Prints one JSON
line per log step: ``step``, ``loss``, ``perplexity`` (the language
models), ``step_ms`` (wall time a step since the last line),
``examples_per_sec`` and, where the preset has a sequence length (GPT,
BERT, seq2seq), ``tokens_per_sec``.  With ``--logdir`` it also appends
``metrics.jsonl`` rows with the Trainer's keys (the loss and the preset's
metrics, the rates, the span breakdown ``t_step``/``t_data``/
``t_dispatch``/``t_host`` with their ``f_*`` shares, device and host
memory, the registry's counters; ``eval_*`` with ``--eval-every``), the
span trees (``trace.jsonl``) and a Prometheus snapshot
(``metrics.prom``), which ``tools/check_metrics_schema.py`` accepts.
Telemetry (``train.py``'s flags): ``--flight-recorder``
(``flight.jsonl``), ``--goodput`` (``goodput.json``), ``--status-port``
(``/healthz /statusz /varz /threadz /memz /flightz /goodputz
/profilez``), ``--profile-dir`` and ``--auto-profile`` (``torch.profiler``
windows), ``--target-metric`` (the accuracy gate), ``--flops-per-step``
or ``--estimate-flops`` (the ``mfu`` field)::

    python train_torch.py --workload mnist_lenet --test-size --device cpu \
        --steps 60 --eval-every 20 --target-metric accuracy \
        --target-value 0.5 --logdir /tmp/r --flight-recorder --goodput

Host time (``train.py``'s flags): ``--steps-per-call k`` runs k optimizer
steps a call (``train.make_multi_train_step``: on the card the first call
runs its k steps eagerly and every later call replays one CUDA graph of k
steps; on the CPU a loop), fed (k, B, ...) bundles, with every hook firing
when a call crosses its period; ``--prefetch-depth`` (default 2) puts the
train and eval batches on the device from a thread of its own
(``data.Prefetcher``; 0: in the loop's thread)::

    python train_torch.py --workload gpt_lm --test-size --device cpu \
        --steps 10 --steps-per-call 3 --log-every 3 --logdir /tmp/k3

Checkpoints (``train.py``'s flags): with ``--checkpoint-dir`` the run
restores the newest verified checkpoint there (logging ``restored
checkpoint step N``), fast-forwards its input past the N batches the
saved run consumed (``fast-forwarding input N batches``) and trains on to
``--steps`` in all, so the same command reruns a cut run to its end.  It
saves every ``--checkpoint-every`` steps (asynchronously) and at the end,
and on SIGTERM saves at the next step boundary and exits with status 0.
``--watchdog-timeout`` dumps every thread's stack when no step is
dispatched for that many seconds; ``--deterministic`` pins the CUDA
arithmetic (``utils.enable_determinism``)::

    python train_torch.py --workload gpt_lm --test-size --device cpu \
        --steps 4 --checkpoint-dir /tmp/ck --checkpoint-every 2
    python train_torch.py --workload gpt_lm --test-size --device cpu \
        --steps 8 --checkpoint-dir /tmp/ck --checkpoint-every 2

Record files (``train.py``'s flags): ``--data-dir`` trains from the record
files there (``*.tfrecord``, ``*.rio``, ``*.rec``, written by
``data.write_record_shards`` of either package) in place of the preset's
synthetic batches, endlessly, each epoch reshuffled (``--shuffle-buffer``,
0 = off); over ranks each rank is one input pipeline and ``--autoshard``
splits the files (FILE), the records (DATA) or nothing (OFF; AUTO = FILE
when the file count divides evenly).  Eval then runs one unshuffled pass
over ``--eval-data-dir`` (default ``--data-dir``), the last batch weighted
by its rows.  ``--config`` takes a JSON file of flag defaults (flags typed
on the command line win) or a preset name::

    python train_torch.py --workload imagenet_resnet50 --test-size \
        --device cpu --steps 4 --batch-size 8 --data-dir /data/train \
        --eval-data-dir /data/val --eval-every 4
    python train_torch.py --config run.json --device cpu

Roles (``train.py``'s ``--job``): ``--job evaluator`` polls
``--checkpoint-dir`` every ``--poll-interval`` seconds and evaluates each
new checkpoint (the newest, skipping the ones in between) until the one
of ``--steps``, ``--max-evaluations`` or ``--idle-timeout`` seconds
without a new one, writing ``eval/<name>`` rows with ``--logdir``;
``--job async-ps`` trains the preset on ``--num-ps`` parameter-server
shards (threads of this process, on the CPU) and ``--num-workers``
worker processes that compute on ``--device`` and push without a
barrier.  ``--job auto`` (the default) takes the role TF_CONFIG gives:
the evaluator for an ``evaluator`` task, a task of the parameter-server
tier for any task of a cluster with a ``ps`` job (the same flags on
every task), else training::

    python train_torch.py --workload mnist_lenet --test-size --device cpu \
        --steps 4 --job evaluator --checkpoint-dir /tmp/ck --max-evaluations 1
    python train_torch.py --job async-ps --workload widedeep --test-size \
        --device cpu --steps 8 --logdir /tmp/ps
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time

import torch

from distributedtensorflow_tpu_torch import obs
from distributedtensorflow_tpu_torch.checkpoint import (
    CheckpointManager,
    PreemptionHandler,
)
from distributedtensorflow_tpu_torch.data import (
    Prefetcher,
    ReplicaBatches,
    current_input_context,
    device_put_batch,
    device_put_bundle,
    replica_is_split,
    replica_leader,
    skip_batches,
)
from distributedtensorflow_tpu_torch.device import resolve_device
from distributedtensorflow_tpu_torch.models import (
    GPTLM,
    flax_modules,
    flax_paths,
    flax_views,
    make_nan_taps,
)
from distributedtensorflow_tpu_torch.parallel import bootstrap
from distributedtensorflow_tpu_torch.parallel.overlap import OverlapPlan
from distributedtensorflow_tpu_torch.parallel.zero import (
    ZERO_SAFE,
    ZeroSharder,
)
from distributedtensorflow_tpu_torch.parallel.mesh import (
    MeshSpec,
    build_mesh,
    parse_mesh,
    replica_count,
)
from distributedtensorflow_tpu_torch.train import (
    Callback,
    Trainer,
    TrainerConfig,
    TrainState,
    create_sharded_state,
    make_eval_step,
    make_multi_train_step,
)
from distributedtensorflow_tpu_torch.train.optimizers import (
    OPTIMIZERS,
    SCHEDULES,
    build_optimizer,
    build_schedule,
    exclude_bias_and_norm_mask,
)
from distributedtensorflow_tpu_torch.utils import enable_determinism
from distributedtensorflow_tpu_torch.workloads import (
    SEQ_PARALLEL,
    WORKLOADS,
    get_workload,
)

logger = logging.getLogger("train_torch")

_REMAT = {"on": True, "off": False, "attn": "attn", None: None}
#: --pp-handoff-dtype -> the pipeline's wire dtype (``train.py:29``).
_PP_HANDOFF = {"fp32": None, "bf16": "bfloat16"}
#: Eval batches per evaluation (``TrainerConfig.eval_steps`` for the
#: synthetic sources, ``train.py:298``).
EVAL_STEPS = 10


def apply_config_file(p: argparse.ArgumentParser, args: argparse.Namespace,
                      argv: list[str]) -> argparse.Namespace:
    """``--config FILE`` (``train.py``'s ``apply_config_file``): the JSON
    file's keys are flag defaults, a flag typed on the command line wins
    (even at its default value), values go through the flag's type, and a
    key that names no flag is an error."""
    explicit = {action.dest for action in p._actions
                for opt in action.option_strings
                if any(a == opt or a.startswith(opt + "=") for a in argv)}
    by_dest = {a.dest: a for a in p._actions}
    with open(args.config) as f:
        cfg = json.load(f)
    for k, v in cfg.items():
        key = k.replace("-", "_")
        action = by_dest.get(key)
        if action is None:
            raise SystemExit(f"config file key {k!r} is not a known flag")
        if key in explicit:
            continue  # the command line wins
        if action.type is not None and v is not None:
            try:
                v = action.type(v)
            except (TypeError, ValueError) as e:
                raise SystemExit(
                    f"config file key {k!r}: invalid value {v!r} ({e})")
        elif isinstance(action.const, bool):  # store_true/false flags
            v = bool(v)
        setattr(args, key, v)
    return args


def record_files(data_dir) -> list[str]:
    """The record files under ``data_dir`` (``train.py:83-92``)."""
    import glob

    files = sorted(f for pat in ("*.tfrecord", "*.rio", "*.rec")
                   for f in glob.glob(os.path.join(data_dir, pat)))
    if not files:
        raise SystemExit(f"{data_dir}: no record files")
    return files


def shardable_batches(it, mesh=None):
    """A ragged final batch truncated to a multiple of the replicas, and
    an empty one dropped (``train.py:93-110``); the eval weights each
    batch by its rows."""
    shard_div = 1 if mesh is None else replica_count(mesh)
    for batch in it:
        n = len(next(iter(batch.values())))
        keep = n - n % shard_div
        if keep == 0:
            continue
        yield batch if keep == n else {k: v[:keep] for k, v in batch.items()}


def build_parser() -> argparse.ArgumentParser:
    """``train_torch.py``'s flags, with ``train.py``'s names, choices and
    defaults where they are twins."""
    # allow_abbrev=False: apply_config_file finds the typed flags by their
    # option strings, which an abbreviation would dodge
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                allow_abbrev=False)
    p.add_argument("--config", default=None,
                   help="a JSON file of flag defaults (flags on the command "
                        "line win), or a workload preset name")
    p.add_argument("--workload", default="mnist_lenet", choices=WORKLOADS)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=None,
                   help="global batch size (default: workload preset)")
    p.add_argument("--accum-steps", type=int, default=None,
                   help="microbatches a step (default: workload preset)")
    p.add_argument("--zero", action="store_true",
                   help="cross-replica weight-update sharding (ZeRO stage "
                        "1, arxiv 2004.13336): reduce-scatter gradients, "
                        "shard the optimizer state + update 1/N per "
                        "data-parallel replica, all-gather updated params "
                        "— per-device optimizer-state bytes shrink by the "
                        "replica count; exact for elementwise optimizers "
                        "(sgd/momentum/adam/adamw/adagrad/lion)")
    p.add_argument("--quant",
                   choices=("none", "int8", "int8_stochastic", "fp8"),
                   default="none",
                   help="quantized compute (ops/quant.py): run the "
                        "transformer presets' block matmuls as int8 (or "
                        "fp8) with per-channel absmax scales and a "
                        "straight-through-estimator backward (QAT-safe); "
                        "embeddings/layernorms/heads stay high-precision; "
                        "stamps quant_mode into every metric record")
    p.add_argument("--overlap", action="store_true",
                   help="collective-matmul overlap (parallel/overlap.py): "
                        "issue the backward-pass gradient all-reduce "
                        "(reduce-scatter under --zero) in per-layer-group "
                        "buckets as each gradient is produced, so the sync "
                        "hides under the remaining backward matmuls; "
                        "numerically identical to the unbucketed step")
    p.add_argument("--overlap-bucket-mb", type=float, default=4.0,
                   help="greedy merge threshold (MiB of parameter bytes) "
                        "for --overlap's per-layer-group gradient buckets")
    p.add_argument("--seq-len", type=int, default=None)
    p.add_argument("--pp-virtual", type=int, default=1,
                   help="virtual pipeline chunks per rank (>1 = circular/"
                        "interleaved schedule, smaller bubble)")
    p.add_argument("--pipeline-schedule",
                   choices=("gpipe", "1f1b", "interleaved"),
                   default="gpipe",
                   help="pipeline training schedule on meshes with a pipe "
                        "axis: gpipe (all forwards, then the backwards — "
                        "O(n_micro) live microbatch activations), 1f1b "
                        "(forward/backward interleaved — O(stages) live "
                        "stage inputs), or interleaved (interleaved-1F1B "
                        "over --pp-virtual>=2 chunks per rank — smaller "
                        "bubble, O(stages*virtual) live stage inputs)")
    p.add_argument("--pp-handoff-dtype", choices=("fp32", "bf16"),
                   default="fp32",
                   help="dtype of the pipeline handoffs' payload on the "
                        "wire: bf16 halves the bytes between stages and is "
                        "bit-exact for bf16 models (requires one); the "
                        "schedule's buffers stay fp32")
    p.add_argument("--job", choices=("auto", "train", "evaluator",
                                     "async-ps"),
                   default="auto",
                   help="role of this process: train, sidecar evaluator "
                        "(polls --checkpoint-dir and evaluates new "
                        "checkpoints), or async-ps (host-side stale-"
                        "gradient parameter-server training, reference "
                        "config #5). auto = evaluator iff TF_CONFIG "
                        "task.type == 'evaluator'; a TF_CONFIG cluster "
                        "WITH a 'ps' job routes ps/chief/worker tasks to "
                        "the async-PS tier (legacy PS launcher semantics)")
    p.add_argument("--num-ps", type=int, default=2,
                   help="async-ps: number of parameter-server shards")
    p.add_argument("--num-workers", type=int, default=2,
                   help="async-ps: number of gradient-worker processes")
    p.add_argument("--poll-interval", type=float, default=10.0,
                   help="evaluator: seconds between checkpoint-dir polls")
    p.add_argument("--max-evaluations", type=int, default=None,
                   help="evaluator: stop after N evaluations")
    p.add_argument("--idle-timeout", type=float, default=600.0,
                   help="evaluator: stop after this long with no new "
                        "checkpoint; ps-cluster ps task: exit after this "
                        "long with no gradient push")
    p.add_argument("--sp-scheme", choices=("ring", "ulysses"),
                   default="ring",
                   help="sequence-parallel attention of the GPT LMs over a "
                        "seq mesh axis: ring (K/V chunks round the ring "
                        "through the flash kernels) or ulysses (all-to-all "
                        "between the sequence and the heads)")
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
    p.add_argument("--kv-heads", type=int, default=None,
                   help="K/V heads (grouped-query attention) of the GPT "
                        "presets and t5_seq2seq")
    p.add_argument("--attn-window", type=int, default=None)
    p.add_argument("--test-size", action="store_true",
                   help="shrink the model (the JAX test sizes: gpt_tiny or "
                        "gpt_moe_tiny at seq 64, bert_tiny at seq 128, "
                        "ResNet-50 at 64x64, widedeep_test_config, "
                        "vit_tiny, seq2seq_tiny at seq 32)")
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default=None,
                   help="compute dtype in place of the preset's (fp32 for "
                        "parity checks: in bf16 each rank rounds its own "
                        "rows' gradients)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--dynamics-every", type=int, default=0,
                   help="training-dynamics telemetry cadence (obs.dynamics): "
                        "every N optimizer steps the train step computes "
                        "per-module grad/param/update statistics on the "
                        "device (steps off the cadence run nothing extra), "
                        "flushed at log boundaries into dynamics.jsonl, the "
                        "dynamics_* metric families, and GET /dynamicz; a "
                        "non-finite loss or grad triggers the NaN-provenance "
                        "pass.  0 disables")
    p.add_argument("--eval-every", type=int, default=0)
    p.add_argument("--target-metric", default=None,
                   help="stop when this eval metric reaches --target-value "
                        "(the reference's accuracy-parity gate)")
    p.add_argument("--target-value", type=float, default=None)
    p.add_argument("--target-mode", choices=("max", "min"), default="max",
                   help="'max': stop when metric >= value; 'min': <= (losses)")
    p.add_argument("--logdir", default=None,
                   help="write metrics.jsonl, trace.jsonl, metrics.prom "
                        "(and flight.jsonl, goodput.json, captures/) here")
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace of a few steps here")
    p.add_argument("--profile-start", type=int, default=10,
                   help="steps into this run before the trace window opens")
    p.add_argument("--profile-steps", type=int, default=5,
                   help="number of steps to trace (also the window length "
                        "of --auto-profile and POST /profilez captures)")
    p.add_argument("--auto-profile", action="store_true",
                   help="reactive profiling: capture a torch.profiler "
                        "window of the next --profile-steps steps the "
                        "moment the anomaly detector flags a step-time "
                        "regression (or, over ranks, the t_step spread "
                        "blows up); captures land in <logdir>/captures/"
                        "<id>/ with a manifest row in <logdir>/"
                        "captures.jsonl")
    p.add_argument("--max-captures", type=int, default=8,
                   help="per-run budget of reactive/on-demand profiler "
                        "captures (--auto-profile, POST /profilez); the "
                        "static --profile-dir window is exempt")
    p.add_argument("--capture-cooldown", type=float, default=120.0,
                   help="seconds between triggered captures (POST "
                        "/profilez skips it)")
    p.add_argument("--status-port", type=int, default=None, metavar="PORT",
                   help="start the live introspection HTTP server on this "
                        "port (0 = ephemeral; a fixed port is offset by "
                        "the rank): /healthz /statusz /varz /threadz /memz "
                        "/flightz /goodputz /profilez")
    p.add_argument("--status-host", default="127.0.0.1", metavar="ADDR",
                   help="bind address for --status-port; the loopback "
                        "default keeps /threadz stacks private — set "
                        "0.0.0.0 only on a trusted cluster network")
    p.add_argument("--fleet", action="store_true",
                   help="fleet observability plane (obs.fleet): scrape "
                        "the /varz of every registered peer StatusServer "
                        "(this process + every --fleet-peer) on a "
                        "background thread, merge into a min/median/max/"
                        "sum view with per-peer up/stale/down liveness + "
                        "spread_ratio straggler detection, served at GET "
                        "/fleetz on --status-port and persisted to "
                        "<logdir>/fleet.json, with a fleet-merged metrics "
                        "history at GET /histz (<logdir>/history.jsonl); "
                        "requires --status-port")
    p.add_argument("--fleet-interval", type=float, default=2.0,
                   help="seconds between fleet /varz scrape rounds")
    p.add_argument("--fleet-peer", action="append", default=None,
                   metavar="NAME=HOST:PORT",
                   help="extra fleet scrape target (repeatable): another "
                        "rank's --status-port, a serve_torch.py server")
    p.add_argument("--slo-rules", default=None, metavar="JSON",
                   help="SLO rule file (obs.slo schema): evaluate "
                        "multi-window burn rates over registry histograms"
                        "/gauges on a background thread, expose "
                        "slo_burn_rate{slo=,window=} gauges + GET /sloz, "
                        "raise slo_violation flight events on threshold "
                        "trips, and (with --auto-profile) arm a slo_burn "
                        "reactive capture on a fast-burn trip")
    p.add_argument("--slo-interval", type=float, default=5.0,
                   help="seconds between SLO burn-rate evaluations")
    p.add_argument("--alert-rules", default=None, metavar="JSON",
                   help="alert rule file (obs.alerts schema): evaluate "
                        "threshold/burn/absence/anomaly rules over the "
                        "registry (and the SLO monitor / history store / "
                        "fleet view when present) on a background thread; "
                        "firings append <logdir>/alerts.jsonl, write "
                        "incident evidence bundles under "
                        "<logdir>/incidents/, raise alert flight events, "
                        "and serve GET /alertz + /healthz?deep=1")
    p.add_argument("--alert-interval", type=float, default=5.0,
                   help="seconds between alert rule evaluations")
    p.add_argument("--alert-webhook", default=None, metavar="URL",
                   help="POST every alert transition to this http:// URL "
                        "as JSON (through net.rpc: deadline, retries, "
                        "circuit breaker)")
    p.add_argument("--flight-recorder", action="store_true",
                   help="record a bounded ring of structured events (step/"
                        "checkpoint/anomaly/preemption/compile markers), "
                        "dumped to <logdir>/flight.jsonl on watchdog "
                        "timeout, crash, anomaly, preemption, and exit")
    p.add_argument("--goodput", action="store_true",
                   help="account every wall-second of the run into exclusive"
                        " goodput buckets (init/compile/train_step/data_wait/"
                        "checkpoint/eval/lost_work/...), persisted to "
                        "<logdir>/goodput.json and MERGED across restarts; "
                        "surfaces goodput_fraction in the registry and "
                        "/goodputz on --status-port")
    p.add_argument("--flops-per-step", type=float, default=0.0,
                   help="this device's model FLOPs per optimizer step "
                        "(analytic 6 N D-style, a multiply-add as 2); "
                        "enables the mfu fields in metrics.jsonl on a card "
                        "of a known kind")
    p.add_argument("--estimate-flops", choices=("auto", "on", "off"),
                   default="auto",
                   help="estimate --flops-per-step: the GPT presets by the "
                        "closed form 6 N + 6 L S E a token (PERF.md section "
                        "2; auto and on), the other presets by "
                        "torch.utils.flop_counter's count of the first "
                        "step (on only: the counter sees PyTorch's "
                        "operators, not the hand-written CUDA kernels, so "
                        "on the card it leaves out the flash-attention and "
                        "LayerNorm work)")
    p.add_argument("--no-trace", action="store_true",
                   help="disable span tracing (trace.jsonl + the per-step "
                        "t_data/t_dispatch/t_host breakdown fields)")
    p.add_argument("--no-anomaly-detection", action="store_true",
                   help="disable the streaming anomaly detector (NaN loss, "
                        "loss spikes, step-time regression)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="save here, and resume from the newest verified "
                        "checkpoint here")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save every N steps (0: at the end and on "
                        "preemption only)")
    p.add_argument("--watchdog-timeout", type=float, default=0.0,
                   help="dump all stacks if no step is dispatched for N "
                        "seconds")
    p.add_argument("--deterministic", action="store_true",
                   help="deterministic CUDA algorithms, cuBLAS workspace "
                        "and cuDNN, TF32 off: a rerun repeats bit for bit")
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="optimizer steps a call of the train step (on the "
                        "card one replayed CUDA graph of k steps; hooks "
                        "fire when a call crosses their period)")
    p.add_argument("--prefetch-depth", type=int, default=2,
                   help="batches (k-step bundles) the input thread keeps "
                        "on the device ahead of the step (the Prefetcher's "
                        "buffer_size); 0 copies each batch in the training "
                        "loop's own thread")
    p.add_argument("--adaptive-prefetch", action="store_true",
                   help="autotune the prefetch depth from consumer "
                        "blocking time (grow while the trainer waits on "
                        "data, shrink when waits are ~0), bounded by "
                        "--prefetch-budget-mb; live depth exported as the "
                        "data_prefetch_depth gauge + per-record field")
    p.add_argument("--prefetch-budget-mb", type=float, default=256.0,
                   help="host-bytes budget bounding the adaptive prefetch "
                        "depth and data-service credit window")
    p.add_argument("--data-service", type=int, default=0, metavar="N",
                   help="disaggregated input: spawn a loopback dispatcher "
                        "plus N in-process data workers serving the "
                        "workload input (or --data-dir records, partitioned "
                        "N ways under this rank's slice) and consume via "
                        "the streaming DataServiceClient — persistent "
                        "pipelined connections, credit window, elastic "
                        "re-sharding on worker death. 0 = direct host input")
    p.add_argument("--data-service-wire", choices=("raw", "npz"),
                   default="raw",
                   help="data-service batch wire format: 'raw' "
                        "(dtype/shape header + raw tensor bytes, the fast "
                        "path) or 'npz' (legacy per-batch archive)")
    p.add_argument("--data-service-window", type=int, default=0,
                   metavar="W",
                   help="per-split credit window of outstanding pipelined "
                        "get_next requests (0 = adaptive: autotuned from "
                        "consumer waits within --prefetch-budget-mb)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--mesh", default=None,
                   help="mesh axes, e.g. 'data=2', 'data=-1' (every "
                        "process of the cluster), 'data=2,model=2' (tensor "
                        "parallelism over model), 'fsdp=2' (a batch axis), "
                        "'data=1,seq=2' (the GPT LMs' sequence split over "
                        "ranks, --sp-scheme), 'data=1,expert=2' (the MoE "
                        "presets' experts split over ranks) or "
                        "'data=1,pipe=2' (the GPT LMs' blocks split into "
                        "pipeline stages, --pipeline-schedule, "
                        "--pp-virtual, --pp-handoff-dtype; with model, and "
                        "with seq under gpipe)")
    p.add_argument("--dist-backend", choices=bootstrap.BACKENDS,
                   default="nccl",
                   help="process-group backend over a mesh: nccl on the "
                        "cards, gloo where asked for (the CPU)")
    p.add_argument("--data-dir", default=None, metavar="DIR",
                   help="train from record files (*.tfrecord/*.rio/*.rec, "
                        "written by data.write_record_shards) instead of the "
                        "workload's synthetic input; keys must match the "
                        "workload's batch keys")
    p.add_argument("--eval-data-dir", default=None, metavar="DIR",
                   help="record files for eval; defaults to --data-dir "
                        "(use a held-out split for honest numbers)")
    p.add_argument("--autoshard", choices=("AUTO", "FILE", "DATA", "OFF"),
                   default="AUTO",
                   help="per-rank input sharding policy for --data-dir")
    p.add_argument("--shuffle-buffer", type=int, default=4096,
                   help="record shuffle buffer for --data-dir (0 = off)")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    p = build_parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = p.parse_args(argv)
    if args.config:
        if os.path.exists(args.config):
            args = apply_config_file(p, args, argv)
        elif args.config in WORKLOADS:  # --config <preset name>
            args.workload = args.config
        else:
            p.error(f"--config {args.config!r}: no such file or preset")
    return args


def apply_optimizer_flags(wl, args, decay_mask=None):
    """--optimizer/--lr/--schedule override the preset's optimizer, with
    ``train.py``'s checks (``apply_optimizer_flags``, ``:125-195``).
    ``decay_mask``: a concrete name -> bool mask in place of the
    bias-norm rule (ZeRO's rows are all of rank 1, ``train.py:198``)."""
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
    if mask is not None and decay_mask is not None:
        mask = decay_mask
    try:
        lr = build_schedule(args.schedule, args.lr,
                            warmup_steps=args.warmup_steps,
                            total_steps=args.steps)
        make = build_optimizer(args.optimizer, lr,
                               weight_decay=args.weight_decay,
                               global_clipnorm=args.clipnorm,
                               decay_mask=mask, views=flax_views(wl.cfg))
    except ValueError as e:
        raise SystemExit(str(e)) from None
    return dataclasses.replace(wl, make_optimizer=make)


def _device_batches(source, device, mesh=None, accum_steps=1, bundle=1):
    """Numpy batches as device tensors in the caller's thread
    (:func:`device_put_batch`), or ``bundle`` of them stacked a time
    (:func:`device_put_bundle`; a short tail at its length)."""
    if bundle <= 1:
        for b in source:
            yield device_put_batch(b, device, mesh, accum_steps=accum_steps)
        return
    while True:
        group = [b for _, b in zip(range(bundle), source)]
        if group:
            yield device_put_bundle(group, device, mesh,
                                    accum_steps=accum_steps)
        if len(group) < bundle:
            return


def device_iter(args, source, device, mesh=None, accum_steps=1, bundle=1,
                adaptive=False):
    """The device batches of ``source``: through a :class:`Prefetcher` of
    ``--prefetch-depth`` (its own thread and, on the card, its own CUDA
    stream; ``adaptive``: the depth tuned within ``--prefetch-budget-mb``),
    or in the caller's thread for depth 0."""
    if args.prefetch_depth > 0:
        return Prefetcher(source, device, mesh, args.prefetch_depth,
                          bundle=bundle, accum_steps=accum_steps,
                          adaptive=adaptive,
                          bytes_budget=int(args.prefetch_budget_mb * 2**20))
    return _device_batches(source, device, mesh, accum_steps, bundle)


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


def workload_of(args: argparse.Namespace):
    """The preset the flags name, with its optimizer flags
    (:func:`apply_optimizer_flags`) and ``--dtype``, not yet bound to a
    mesh."""
    try:
        wl = get_workload(
            args.workload, test_size=args.test_size,
            global_batch_size=args.batch_size, sp_scheme=args.sp_scheme,
            seq_len=args.seq_len, remat=_REMAT[args.remat],
            attn_impl=args.attn_impl,
            xent_impl=args.xent_impl, kv_heads=args.kv_heads,
            attn_window=args.attn_window, quant=args.quant,
            pp_virtual=args.pp_virtual,
            pp_handoff=_PP_HANDOFF[args.pp_handoff_dtype],
            pp_schedule=args.pipeline_schedule)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    wl = apply_optimizer_flags(wl, args)
    if args.dtype:
        wl = dataclasses.replace(wl, cfg=dataclasses.replace(
            wl.cfg, dtype=getattr(torch, args.dtype)))
    return wl


def build(args: argparse.Namespace, checkpointer=None, feed=None):
    """``(workload, state, step_fn, batches)`` for ``args``: the model
    from seeded random weights on the device, the optimizer, the train
    step (``--steps-per-call`` k > 1: k steps a call, and the batches
    come as (k, B, ...) bundles) and an iterator of device batches
    (:func:`device_iter`); over a mesh (see
    :func:`bootstrap_mesh`) this rank's state, step and share of each
    batch.  With a ``checkpointer`` (a ``CheckpointManager``) the state
    is its newest verified checkpoint, if it has one, and the batches
    start after the ones the saved run consumed.  With
    ``--data-service`` the batches come through ``feed`` (the run's
    :class:`DataServiceFeed`); over ``pipe``, ``seq``, ``expert`` or
    ``model`` only the replica's first rank reads it, and every rank of
    the replica steps on its batches
    (:class:`~distributedtensorflow_tpu_torch.data.ReplicaBatches`)."""
    mesh, device = bootstrap_mesh(args)
    if checkpointer is not None and mesh is not None:
        # every rank of the mesh takes part in a save (a split model's
        # pieces are gathered) and in the preemption's agreement
        checkpointer.set_mesh(mesh.world)
    wl = workload_of(args).for_mesh(mesh)
    accum = wl.accum_steps if args.accum_steps is None else args.accum_steps
    replicas = 1 if mesh is None else replica_count(mesh)
    if wl.global_batch_size % (replicas * accum):
        raise SystemExit(f"global batch {wl.global_batch_size} not divisible "
                         f"by {replicas} replicas x {accum} microbatches")
    group = {"group": mesh} if mesh is not None else {}
    try:
        model = wl.model_cls(wl.cfg, device=device,
                             **(group if wl.model_takes_group else {}))
    except ValueError as e:  # a pipeline the mesh and flags cannot make
        raise SystemExit(str(e)) from None
    if hasattr(model, "bubble_fraction"):
        logger.info("pipeline: %s over %d stages x %d chunks, %d "
                    "microbatches, bubble %.3f", model.schedule,
                    model.n_stages, model.n_virtual, model.n_microbatches,
                    model.bubble_fraction())
    model.load_state_dict(
        wl.init_params(wl.cfg, torch.Generator().manual_seed(args.seed)))
    zero = zero_sharder(args, mesh)
    if zero is not None and args.decay_mask == "bias-norm":
        # resolved on the whole parameters: ZeRO's rows are all rank 1
        wl = apply_optimizer_flags(wl, args, decay_mask=dict(
            exclude_bias_and_norm_mask(model.named_parameters())))
    if mesh is not None:
        state, _ = create_sharded_state(model, wl.make_optimizer, mesh,
                                        cfg=wl.cfg, rules=wl.layout,
                                        zero=zero)
    else:
        state = TrainState.create(model, wl.make_optimizer)
    state.overlap = overlap_plan(args, model, mesh, zero, wl.cfg)
    if checkpointer is not None:
        checkpointer.restore_latest(state)
    step = make_multi_train_step(
        wl.loss_fn(model, **group), steps_per_call=args.steps_per_call,
        accum_steps=accum, seed=args.seed, mesh=mesh,
        dynamics_every=args.dynamics_every,
        dynamics_modules=dynamics_modules(wl.cfg, model))
    ctx = current_input_context(wl.global_batch_size, mesh)
    # the service's order is its client's: over a split axis only the
    # replica's first rank reads it, and the others take its batches
    split = args.data_service and replica_is_split(mesh)
    if split and not replica_leader(mesh):
        return wl, state, step, ReplicaBatches(None, mesh, device)
    if args.data_service:
        if feed is None:
            raise ValueError("--data-service: build() takes the run's "
                             "DataServiceFeed")
        source = feed.source(wl, ctx)
    elif args.data_dir:
        source = record_source(args, ctx)
    else:
        source = wl.input_fn(ctx, args.seed)
    if state.step:
        logger.info("fast-forwarding input %d batches", state.step)
        source = skip_batches(source, state.step)
    batches = device_iter(args, source, device, mesh, accum,
                          bundle=args.steps_per_call,
                          adaptive=args.adaptive_prefetch)
    if split:
        batches = ReplicaBatches(batches, mesh, device)
    return wl, state, step, batches


class DataServiceFeed:
    """``--data-service N`` (``train.py:1164-1226,1251-1310``): a
    loopback :class:`~distributedtensorflow_tpu_torch.data.DispatchServer`
    and N in-process
    :class:`~distributedtensorflow_tpu_torch.data.WorkerServer` s, each
    serving one split of this rank's input pipeline: the preset's
    synthetic stream from seed ``--seed + 1009 (split + 1)``, or the
    ``--data-dir`` records as pipeline ``id x N + split`` of ``pipelines x
    N``.  :meth:`source` starts them and reads the run's one epoch
    through the streaming
    :class:`~distributedtensorflow_tpu_torch.data.DataServiceClient`
    (``--data-service-wire``, ``--data-service-window``, the credit
    window's bytes budget ``--prefetch-budget-mb``); :meth:`stop` ends
    the client, the workers and the dispatcher, where train.py leaves
    them to the process's exit.  Under ``--fleet`` each worker embeds a
    status server, a peer of the fleet.

    The dispatcher journals to ``dispatcher.journal`` under ``--logdir``
    (input pipeline ``i`` > 0: ``dispatcher.<i>.journal``), a new one
    each run: an earlier run's journal names workers that are gone and
    an epoch this run does not read, so it is replaced, not replayed."""

    def __init__(self, args):
        self.args = args
        self.dispatcher = None
        self.workers: list = []
        self.client = None

    def _journal(self, ctx) -> str | None:
        if not self.args.logdir:
            return None
        pipeline = ctx.input_pipeline_id
        path = os.path.join(self.args.logdir, "dispatcher.journal"
                            if not pipeline else
                            f"dispatcher.{pipeline}.journal")
        if os.path.exists(path):
            logger.info("data service: replacing %s (an earlier run's)",
                        path)
            os.remove(path)
        return path

    def source(self, wl, ctx):
        """Start the service and return the client of its epoch."""
        from distributedtensorflow_tpu_torch.data import (
            DataServiceClient,
            DispatchServer,
            InputContext,
            WorkerServer,
            repeated_record_dataset,
        )

        args = self.args

        def input_fn(split, num_shards):
            if args.data_dir:
                # pipeline (id * N + split) of (pipelines * N), each a
                # whole per-rank batch
                wctx = InputContext(
                    num_input_pipelines=ctx.num_input_pipelines * num_shards,
                    input_pipeline_id=ctx.input_pipeline_id * num_shards
                    + split,
                    global_batch_size=wl.global_batch_size * num_shards)
                return repeated_record_dataset(
                    record_files(args.data_dir), wctx,
                    batch_size=ctx.per_host_batch_size,
                    policy=args.autoshard,
                    shuffle_buffer=args.shuffle_buffer,
                    seed=args.seed + split)
            return wl.input_fn(ctx, args.seed + 1009 * (split + 1))

        self.dispatcher = DispatchServer(port=0,
                                         journal_path=self._journal(ctx))
        try:
            for _ in range(args.data_service):
                self.workers.append(WorkerServer(
                    self.dispatcher.target(), input_fn, port=0,
                    status_port=0 if args.fleet else None))
            logger.info("data service: dispatcher %s + %d loopback "
                        "worker(s), wire=%s", self.dispatcher.target(),
                        len(self.workers), args.data_service_wire)
            self.client = DataServiceClient(
                self.dispatcher.target(), epoch=0,
                wire=args.data_service_wire,
                window=args.data_service_window or 2,
                adaptive_window=args.data_service_window == 0,
                bytes_budget=int(args.prefetch_budget_mb * 2**20))
        except BaseException:
            self.stop()
            raise
        return self.client

    def stop(self) -> None:
        """Close the client, then stop the workers and the dispatcher
        (idempotent)."""
        if self.client is not None:
            self.client.close()
            self.client = None
        workers, self.workers = self.workers, []
        for w in workers:
            w.stop()
        if self.dispatcher is not None:
            self.dispatcher.stop()
            self.dispatcher = None


def dynamics_modules(cfg, model) -> dict[str, str]:
    """The top-level modules the dynamics group a model's parameters by:
    the flax tree's (``models.flax_modules``), or for a pipelined model
    JAX's pipelined tree's (``blocks``, ``ln_f``, ``wte``)."""
    if hasattr(model, "bubble_fraction"):
        from distributedtensorflow_tpu_torch.models.gpt_pipeline import (
            pipeline_modules,
        )

        return pipeline_modules(cfg)
    return flax_modules(cfg)


def zero_sharder(args, mesh):
    """``--zero``'s sharder over the mesh's replicas, or None; warns, as
    ``train.py:1044-1067`` does, for a single replica (nothing to shard)
    and for an optimizer whose update is not elementwise."""
    if not args.zero:
        return None
    replicas = 1 if mesh is None else replica_count(mesh)
    if replicas <= 1:
        logger.warning("--zero: mesh %s has a single data-parallel replica; "
                       "nothing to shard the weight update over — running "
                       "replicated", None if mesh is None else mesh.shape)
        return None
    if args.optimizer and args.optimizer not in ZERO_SAFE:
        logger.warning(
            "--zero with --optimizer %s: its update is not elementwise "
            "(per-shard norms/factored stats), so the trajectory will "
            "deviate from replicated data parallelism; elementwise "
            "optimizers (%s) are exact", args.optimizer, ", ".join(ZERO_SAFE))
    zero = ZeroSharder(mesh)
    logger.info("zero: sharding optimizer state + weight update %d-way over "
                "axes %s", zero.degree, zero.axes)
    return zero


def overlap_plan(args, model, mesh, zero, cfg):
    """``--overlap``'s bucketed gradient sync, or None (with a warning
    for a single replica: there is no gradient collective to overlap)."""
    if not args.overlap:
        return None
    replicas = 1 if mesh is None else replica_count(mesh)
    if replicas <= 1:
        logger.warning("--overlap: mesh %s has a single data-parallel "
                       "replica; there is no gradient collective to "
                       "overlap — running without bucketing",
                       None if mesh is None else mesh.shape)
        return None
    plan = OverlapPlan.build(model, mesh, zero=zero, paths=flax_paths(cfg),
                             bucket_bytes=int(args.overlap_bucket_mb * 2**20))
    logger.info("overlap: %d gradient bucket(s), mode=%s, coverage=%.0f%%",
                len(plan.buckets), plan.describe()["mode"],
                100 * plan.coverage)
    return plan


def record_source(args, ctx):
    """Endless batches of this rank's share of the ``--data-dir`` records,
    each epoch reshuffled with ``seed + epoch`` (``train.py:1272-1283``)."""
    from distributedtensorflow_tpu_torch.data import repeated_record_dataset

    files = record_files(args.data_dir)
    logger.info("reading %d record files (%s sharding)", len(files),
                args.autoshard)
    return repeated_record_dataset(
        files, ctx, batch_size=ctx.per_host_batch_size,
        policy=args.autoshard, shuffle_buffer=args.shuffle_buffer,
        seed=args.seed,
        on_epoch=lambda e: logger.info("input epoch %d complete", e))


def record_eval_source(args, ctx, mesh=None):
    """One finite, unshuffled pass over the eval records, its ragged last
    batch kept (``train.py:1612-1615``)."""
    from distributedtensorflow_tpu_torch.data import record_dataset

    files = record_files(args.eval_data_dir or args.data_dir)
    return shardable_batches(record_dataset(
        files, ctx, batch_size=ctx.per_host_batch_size,
        policy=args.autoshard, shuffle_buffer=0, drop_remainder=False), mesh)


def flops_per_token(model, cfg, seq) -> tuple[float, str]:
    """A GPT preset's model flops per token, 6 N + 6 L S E (PERF.md
    section 2; a multiply-add as 2), and how N was counted.  In an MoE
    model a token runs only the experts it is routed to, so of the
    experts' parameters N counts the router's assignments per token over
    the number of experts (2 of 8 at top-2)."""
    n = sum(p.numel() for p in model.parameters())
    n_experts = sum(p.numel() for name, p in model.named_parameters()
                    if ".experts_" in name)
    how = "N all parameters, the tied table once"
    if n_experts:
        from distributedtensorflow_tpu_torch.parallel import moe
        active = moe._ASSIGNMENTS[cfg.router] / cfg.n_experts
        n -= n_experts * (1.0 - active)
        how = (f"N all parameters less the experts a token skips: "
               f"{n_experts} expert parameters x {1.0 - active}")
    return 6 * n + 6 * cfg.num_layers * seq * cfg.hidden_size, how


def _counting_first_step(step, config: TrainerConfig):
    """``step`` whose first call runs under ``torch.utils.flop_counter``
    and sets ``config.flops_per_step`` to what it counted over the steps
    of that call (k of a multi-step call: the count is divided by them,
    so it stays per optimizer step)."""
    from torch.utils.flop_counter import FlopCounterMode

    first = [True]

    def counted(state, batch):
        if not first[0]:
            return step(state, batch)
        first[0] = False
        steps = next(iter(batch.values())).shape[0] \
            if config.steps_per_call > 1 else 1
        with FlopCounterMode(display=False) as counter:
            out = step(state, batch)
        config.flops_per_step = float(counter.get_total_flops()) / steps
        logger.info("mfu: flop counter counts %.4g FLOPs in the first step",
                    config.flops_per_step)
        return out

    return counted


def pipeline_fields(model) -> dict:
    """``train.py``'s ``pipeline_*`` stamps of a pipelined model
    (``train.py:1425-1433``) for ``TrainerConfig``; none for another
    model."""
    if not hasattr(model, "bubble_fraction"):
        return {}
    return dict(pipeline_schedule=model.schedule,
                pipeline_stages=model.n_stages,
                pipeline_microbatches=model.n_microbatches,
                pipeline_virtual=model.n_virtual,
                pipeline_bubble=model.bubble_fraction())


class _PrintRecords(Callback):
    """train_torch's one JSON line a log step (printed by the chief), from
    the Trainer's record, gathered into ``records``."""

    def __init__(self, wl, chief: bool):
        self.wl, self.chief, self.records = wl, chief, []

    def on_log(self, trainer, step, record):
        step_s = record["t_step"]
        rec = {"step": step, "loss": record["loss"]}
        if "perplexity" in record:
            rec["perplexity"] = record["perplexity"]
        rec["step_ms"] = 1e3 * step_s
        rec["examples_per_sec"] = self.wl.global_batch_size / step_s
        if self.wl.seq_len:
            rec["tokens_per_sec"] = (self.wl.global_batch_size
                                     * self.wl.seq_len / step_s)
        if self.chief:
            print(json.dumps(rec), flush=True)
        self.records.append(rec)


def check_flags(args) -> None:
    """train.py's setup checks of the telemetry, input and scale-out
    flags, and the port's own refusals of what it has not ported."""
    spec = parse_mesh(args.mesh)
    if spec is not None and (spec.model > 1 or spec.expert > 1) \
            and args.optimizer == "adafactor":
        raise SystemExit("--optimizer adafactor over a model or expert axis "
                         "is not ported (its factored moments and RMS terms "
                         "span the whole parameter)")
    if spec is not None and (spec.seq > 1 or spec.expert > 1) \
            and args.steps_per_call > 1:
        raise SystemExit("--steps-per-call > 1 over a seq or expert axis is "
                         "not ported (no CUDA graph has captured their "
                         "collectives; ROADMAP.md: it waits for two "
                         "NCCL-linked cards)")
    if spec is not None and spec.pipe > 1:
        if args.workload not in SEQ_PARALLEL:
            raise SystemExit(f"--mesh pipe={spec.pipe}: the pipeline is for "
                             f"the GPT LMs ({', '.join(SEQ_PARALLEL)}), not "
                             f"{args.workload}")
        if args.steps_per_call > 1:
            raise SystemExit("--steps-per-call > 1 over a pipe axis is not "
                             "ported (no CUDA graph has captured the "
                             "handoffs; ROADMAP.md: it waits for two "
                             "NCCL-linked cards)")
    if args.steps_per_call < 1:
        raise SystemExit(f"--steps-per-call must be >= 1, got "
                         f"{args.steps_per_call}")
    if args.steps_per_call > 1 and (args.zero or args.overlap):
        raise SystemExit("--steps-per-call > 1 with --zero or --overlap is "
                         "not ported (their collectives and hooks are "
                         "untried under the k-step CUDA graph; ROADMAP.md: "
                         "it waits for two NCCL-linked cards)")
    if args.prefetch_depth < 0:
        raise SystemExit(f"--prefetch-depth must be >= 0, got "
                         f"{args.prefetch_depth}")
    if args.adaptive_prefetch and args.prefetch_depth == 0:
        raise SystemExit("--adaptive-prefetch needs --prefetch-depth > 0 "
                         "(depth 0 has no prefetch queue to tune)")
    if args.data_service < 0:
        raise SystemExit(f"--data-service must be >= 0, got "
                         f"{args.data_service}")

    if args.target_metric:  # the gate must be able to fire
        if args.target_value is None:
            raise SystemExit("--target-metric requires --target-value")
        if not args.eval_every:
            raise SystemExit("--target-metric requires --eval-every > 0")


class _Planes:
    """The operations planes of a run (``train.py:1485-1610``): the fleet
    aggregator (``--fleet``), the SLO monitor (``--slo-rules``), the
    fleet-merged metrics history (``--fleet``) and the alert manager
    (``--alert-rules``), each on its own thread, served on the Trainer's
    status server; :meth:`stop` ends them as ``train.py``'s ``finally``
    does.  Over ranks only the chief writes their files."""

    def __init__(self, args, trainer, dynamics=None, feed=None):
        self.args = args
        self.feed = feed
        self.fleet = self.slo = self.history = self.alerts = None
        self.dynamics = dynamics
        try:
            self._start(trainer)
        except BaseException:
            self.stop()  # the planes that did start
            raise

    def _start(self, trainer) -> None:
        args, dynamics = self.args, self.dynamics
        server = trainer.status_server
        logdir = args.logdir if bootstrap.is_chief() else None
        if dynamics is not None and server is not None:
            dynamics.install(server)
        capture = trainer.capture if args.auto_profile else None
        if args.fleet:
            if server is None:
                raise SystemExit(
                    "--fleet requires --status-port (the aggregator serves "
                    "/fleetz on the chief's StatusServer and scrapes its "
                    "/varz as the chief peer)"
                )
            self.fleet = obs.FleetAggregator(
                interval_s=args.fleet_interval, logdir=logdir)
            # scrape the chief on the interface it bound (loopback when
            # it bound the wildcard)
            chief_host = ("127.0.0.1" if args.status_host in ("0.0.0.0", "")
                          else args.status_host)
            self.fleet.add_peer("chief", f"{chief_host}:{server.port}")
            for i, w in enumerate(self.feed.workers if self.feed else []):
                if w.status_addr is not None:  # its status server bound
                    self.fleet.add_peer(f"data_worker{i}", w.status_addr)
            for spec in args.fleet_peer or []:
                name, sep, addr = spec.partition("=")
                if not sep or not name or not addr:
                    raise SystemExit(
                        f"--fleet-peer {spec!r}: expected NAME=HOST:PORT")
                self.fleet.add_peer(name, addr)
            self.fleet.install(server).start()
            logger.info("fleet: aggregating %d peer(s) every %.1fs (GET "
                        "/fleetz on port %d)", len(self.fleet.peers()),
                        args.fleet_interval, server.port)
        if args.slo_rules:
            try:
                rules = obs.slo.load_rules(args.slo_rules)
            except (OSError, ValueError, json.JSONDecodeError) as e:
                raise SystemExit(f"--slo-rules {args.slo_rules}: {e}")
            self.slo = obs.SLOMonitor(rules, interval_s=args.slo_interval,
                                      capture_engine=capture)
            if server is not None:
                self.slo.install(server)
            self.slo.start()
            logger.info("slo monitor: %d rule(s) from %s evaluated every "
                        "%.1fs", len(rules), args.slo_rules,
                        args.slo_interval)
        if self.fleet is not None:
            # the chief's windowed, fixed-memory history of its registry
            # and the fleet-merged median/max (and the SLO good/total
            # snapshots), at GET /histz and in history.jsonl
            self.history = obs.MetricsHistory(
                interval_s=args.fleet_interval, logdir=logdir,
                rules=self.slo.rules if self.slo is not None else None,
                fleet=self.fleet,
            ).install(server).start()
            logger.info("metrics history: fleet-merged sampling every "
                        "%.1fs (GET /histz)", args.fleet_interval)
            if dynamics is not None:
                dynamics.attach_history(self.history)
        if args.alert_rules:
            try:
                alert_rules = obs.alerts.load_rules(args.alert_rules)
            except (OSError, ValueError, json.JSONDecodeError) as e:
                raise SystemExit(f"--alert-rules {args.alert_rules}: {e}")
            sinks = [obs.alerts.log_sink]
            if args.alert_webhook:
                sinks.append(obs.alerts.make_webhook_sink(args.alert_webhook))
            self.alerts = obs.AlertManager(
                alert_rules, interval_s=args.alert_interval,
                logdir=logdir, history=self.history, fleet=self.fleet,
                slo_monitor=self.slo, capture_engine=capture, sinks=sinks)
            if server is not None:
                self.alerts.install(server)
                # /healthz?deep=1: the alerting, SLO and fleet planes on
                # top of the shallow watchdog verdict
                components = {"alerts": self.alerts.health_component}
                if self.slo is not None:
                    components["slo"] = obs.alerts.slo_health_component(
                        self.slo)
                if self.fleet is not None:
                    components["fleet"] = obs.alerts.fleet_health_component(
                        self.fleet)
                server.deep_health_fn = obs.alerts.compose_deep_health(
                    components)
            self.alerts.start()
            logger.info(
                "alerts: %d rule(s) from %s evaluated every %.1fs%s",
                len(alert_rules), args.alert_rules, args.alert_interval,
                f" (webhook {args.alert_webhook})" if args.alert_webhook
                else "")

    def stop(self) -> None:
        """One last evaluation and scrape, then the registry snapshot
        again: the Trainer wrote metrics.prom at its last log step,
        before these final gauge updates."""
        if self.alerts is not None:
            # before the SLO monitor: stop() runs one final evaluation so
            # resolve rows land, and burn rules read the monitor's state
            self.alerts.stop()
        if self.slo is not None:
            self.slo.stop()
            try:
                self.slo.evaluate()
            except Exception:
                logger.exception("final slo evaluation failed")
        if self.history is not None:
            self.history.stop()
        if self.fleet is not None:
            self.fleet.stop()
        if self.dynamics is not None:
            self.dynamics.close()
        if (self.slo is not None or self.fleet is not None
                or self.alerts is not None) and self.args.logdir \
                and bootstrap.is_chief():
            try:
                obs.default_registry().write_prometheus(
                    os.path.join(self.args.logdir, "metrics.prom"))
            except OSError:
                logger.exception("final metrics.prom export failed")


def resolve_job(args) -> tuple[str, tuple | None]:
    """``(job, ps_cluster)``: ``--job``, or for ``auto`` the role TF_CONFIG
    gives (``train.py:922-954``): an ``evaluator`` task is outside the
    training cluster and runs the sidecar; a cluster WITH a ``ps`` job is
    the legacy parameter-server launcher path (``ps-cluster``, with
    ``(cluster, task type, task index)``): ps tasks serve shards, chief
    and worker tasks run the async pull/push loop.  Clusters without
    ``ps`` train synchronously.  A malformed TF_CONFIG trains (and never
    routes into the PS tier on a half-parsed cluster)."""
    if args.job != "auto":
        return args.job, None
    tf_config = os.environ.get("TF_CONFIG")
    task_type, task_index, cluster = None, 0, {}
    try:
        if tf_config:
            parsed = json.loads(tf_config)
            cluster = parsed.get("cluster", {}) or {}
            task = parsed.get("task", {}) or {}
            task_type = task.get("type")
            task_index = int(task.get("index", 0))
    except (ValueError, AttributeError, TypeError):
        task_type, task_index, cluster = None, 0, {}
    if task_type == "evaluator":
        return "evaluator", None
    if cluster.get("ps"):
        return "ps-cluster", (cluster, task_type, task_index)
    return "train", None


def run_evaluator(args) -> dict[int, dict]:
    """The sidecar-evaluator role (``train.py:217-313``): poll
    ``--checkpoint-dir`` and evaluate each new checkpoint on
    ``--device``, standalone (it never joins the training cluster).  The
    template is the trainer's preset with the same workload and optimizer
    flags, in one process: unchunked, so a ``--zero`` trainer's
    checkpoint is re-cut into it on restore (its decay mask is then the
    plain bias-norm rule, as the trainer's without ZeRO).  Evaluates one
    finite unshuffled pass over ``--eval-data-dir``/``--data-dir``, or
    ``EVAL_STEPS`` synthetic batches of seed ``--seed + 999``; stops
    after the checkpoint of ``--steps``, ``--max-evaluations`` or
    ``--idle-timeout`` seconds without a new one.  Returns ``{step:
    metrics}``; with ``--logdir`` the ``eval/<name>`` rows go to
    ``metrics.jsonl``."""
    from distributedtensorflow_tpu_torch.train import SidecarEvaluator

    if not args.checkpoint_dir:
        raise SystemExit("--job evaluator requires --checkpoint-dir")
    if args.deterministic:
        enable_determinism()
    device = resolve_device(args.device)
    wl = workload_of(args).for_mesh(None)
    logger.info("evaluator: workload=%s device=%s watching %s", wl.name,
                device, args.checkpoint_dir)
    model = wl.model_cls(wl.cfg, device=device)
    model.load_state_dict(
        wl.init_params(wl.cfg, torch.Generator().manual_seed(args.seed)))
    state = TrainState.create(model, wl.make_optimizer)
    eval_step = make_eval_step(wl.eval_fn(model))
    ctx = current_input_context(wl.global_batch_size)
    if args.eval_data_dir or args.data_dir:
        source, eval_steps = (lambda: record_eval_source(args, ctx)), 0
    else:
        source = lambda: wl.input_fn(ctx, args.seed + 999)  # noqa: E731
        eval_steps = EVAL_STEPS  # synthetic iterators are endless
    sidecar = SidecarEvaluator(
        CheckpointManager(args.checkpoint_dir),
        eval_step,
        lambda: device_iter(args, source(), device),
        state,
        eval_steps=eval_steps,
        poll_interval_s=args.poll_interval,
        max_evaluations=args.max_evaluations,
        stop_after_step=args.steps if args.steps > 0 else None,
        idle_timeout_s=args.idle_timeout,
        logdir=args.logdir,
    )
    history = sidecar.run()
    logger.info("evaluator: done; evaluated %d checkpoints", len(history))
    return history


def _ps_partitioner():
    """The PS placement of both async roles: variables over 64 KiB split
    by rows (``train.py:345,471``)."""
    from distributedtensorflow_tpu_torch.parallel.sharding import (
        MinSizePartitioner,
    )

    return MinSizePartitioner(min_shard_bytes=64 << 10)


def run_async_ps(args) -> list[dict]:
    """The async parameter-server role (``train.py:316-417``, reference
    config #5): this process hosts ``--num-ps`` PS shards as threads (on
    the CPU) and spawns ``--num-workers`` gradient-worker processes that
    compute on ``--device``, pushing without a barrier (stale
    gradients).  Records (also ``--logdir``'s ``metrics.jsonl``): the
    global version as it moves, then a final one with the first and last
    mean losses, the staleness histogram of every push and the preset's
    eval metrics on the final parameters; ``--target-metric`` gates on
    them.  Returns the records; the servers and workers are stopped when
    it returns or raises."""
    import time as time_mod

    from distributedtensorflow_tpu_torch.parallel.param_server import (
        AsyncPSTrainer,
    )
    from distributedtensorflow_tpu_torch.utils.metrics import MetricWriter

    if args.target_metric and args.target_value is None:
        raise SystemExit("--target-metric requires --target-value")
    batch = args.batch_size or 256
    # the train and evaluator roles' optimizer flags and checks
    base_wl = get_workload(args.workload, test_size=args.test_size,
                           global_batch_size=batch * args.num_workers)
    flagged = apply_optimizer_flags(base_wl, args)
    kwargs = {}
    if flagged is not base_wl:
        kwargs["make_optimizer"] = flagged.make_optimizer
    records: list[dict] = []
    writer = MetricWriter(args.logdir, use_tensorboard=False)
    try:
        trainer = AsyncPSTrainer(
            args.workload, num_ps=args.num_ps, num_workers=args.num_workers,
            steps=args.steps, batch_size=batch, test_size=args.test_size,
            partitioner=_ps_partitioner(), seed=args.seed,
            device=args.device, dtype=args.dtype, **kwargs)
    except BaseException:
        writer.close()
        raise
    logger.info(
        "async-ps: workload=%s ps=%d workers=%d steps=%d batch=%d/worker",
        args.workload, args.num_ps, args.num_workers, args.steps, batch)

    def record(rec):
        records.append(rec)
        writer.write_record(rec)

    total = args.num_workers * args.num_ps * args.steps
    with writer, trainer:
        trainer.start()
        last = -1
        while True:
            try:
                trainer.join(timeout=2.0)
                break
            except TimeoutError:
                pass
            v = trainer.global_version()
            if v != last:
                record({"time": time_mod.time(), "global_version": v,
                        "of": total})
                logger.info("async-ps: %d/%d updates applied", v, total)
            last = v
        metrics = trainer.evaluate(batches=4)
        hist: dict[str, int] = {}
        for st in trainer.ps_stats():
            for k, n in st["staleness_hist"].items():
                hist[k] = hist.get(k, 0) + n
        first, last_loss = trainer.first_last_mean_loss()
        logger.info(
            "async-ps: done — %d updates, loss %.4f -> %.4f, staleness %s, "
            "eval %s", trainer.global_version(), first, last_loss,
            dict(sorted(hist.items(), key=lambda kv: int(kv[0]))),
            {k: round(v, 4) for k, v in metrics.items()})
        record({"time": time_mod.time(), "final": True,
                "loss_first": first, "loss_last": last_loss,
                "staleness_hist": hist, **metrics})
        if args.target_metric:
            got = metrics.get(args.target_metric)
            if got is None:
                raise SystemExit(
                    f"--target-metric {args.target_metric} not in {metrics}")
            ok = (got >= args.target_value if args.target_mode == "max"
                  else got <= args.target_value)
            if not ok:
                raise SystemExit(
                    f"async-ps: target {args.target_metric}="
                    f"{args.target_value} not reached (got {got:.4f})")
            logger.info("async-ps: target %s=%s reached (%.4f)",
                        args.target_metric, args.target_value, got)
    return records


def _ps_wait_s() -> float:
    """A worker's wait for the PS tier to answer (seconds,
    ``DTFT_PS_WAIT_S``, default 180).  ONE definition: the ps tier's
    startup grace is derived from it, so the two clocks cannot drift
    apart (``train.py:420-425``)."""
    return float(os.environ.get("DTFT_PS_WAIT_S", "180"))


def run_ps_cluster_task(args, cluster, task_type, task_index) -> list[dict]:
    """One task of a TF_CONFIG parameter-server cluster
    (``train.py:427-548``): a ``ps`` task serves its shard (on the CPU)
    until the job's push budget is absorbed; ``chief`` and ``worker``
    tasks run the async pull -> grad -> push loop on ``--device``, the
    chief as worker 0 and the workers after the chiefs.  Every task
    derives byte-identical shards and placement from the shared flags
    (``build_cluster_pieces``), so the bootstrap moves no parameters.
    Returns one record: the ps task's final version, or the worker's
    losses and staleness histogram.  Starts no process group."""
    from distributedtensorflow_tpu_torch.parallel.param_server import (
        AsyncPSClient,
        PSServer,
        PSUnavailableError,
        build_cluster_pieces,
        worker_loop,
    )

    if task_type not in ("ps", "chief", "worker"):
        raise SystemExit(
            f"TF_CONFIG task.type {task_type!r} has no role in a ps "
            "cluster (expected ps, chief, or worker)")
    ps_addrs = list(cluster["ps"])
    chiefs = list(cluster.get("chief", []))
    workers = chiefs + list(cluster.get("worker", []))
    num_ps, num_workers = len(ps_addrs), len(workers)
    if num_workers == 0:
        raise SystemExit("TF_CONFIG ps cluster has no chief/worker tasks")
    batch = args.batch_size or 256
    spec = {"workload": args.workload, "steps": args.steps,
            "batch_size": batch, "test_size": args.test_size,
            "seed": args.seed, "sleep_s": 0.0, "device": args.device,
            "dtype": args.dtype}
    base_wl = get_workload(args.workload, test_size=args.test_size,
                           global_batch_size=batch * num_workers)
    flagged = apply_optimizer_flags(base_wl, args)
    make_opt = flagged.make_optimizer if flagged is not base_wl else None
    _wl, shards, plan, make_opt = build_cluster_pieces(
        spec, num_ps, num_workers, _ps_partitioner(), make_opt,
        workload_obj=base_wl)

    if task_type == "ps":
        host, port = ps_addrs[task_index].rsplit(":", 1)
        bind = host if host in ("127.0.0.1", "localhost") else "0.0.0.0"
        server = PSServer(shards[task_index], make_opt, port=int(port),
                          bind=bind)
        try:
            total = num_workers * args.steps  # one push per worker-step
            logger.info(
                "ps task %d/%d serving %d vars on %s (budget %d pushes)",
                task_index, num_ps, len(shards[task_index]),
                ps_addrs[task_index], total)
            # the startup grace covers the workers' own bounded wait for
            # the tier (DTFT_PS_WAIT_S) plus build slack, so the ps tier
            # never idles out while a slow worker is still starting
            grace = max(float(args.idle_timeout or 0), _ps_wait_s() + 120)
            version = server.serve_until(
                total, idle_timeout_s=args.idle_timeout,
                startup_grace_s=grace)
            logger.info("ps task %d done at version %d", task_index,
                        version)
        finally:
            server.stop()
        return [{"ps_task": task_index, "version": version,
                 "budget": total}]

    # chief/worker: the chief is worker 0 (it trains too, the common TF
    # arrangement); "worker" indices shift past the chiefs
    worker_id = task_index if task_type == "chief" \
        else task_index + len(chiefs)
    # a bounded wait for the PS tier to come up (tasks start unordered)
    client = AsyncPSClient(ps_addrs, plan, worker_id=worker_id)
    wait_s = _ps_wait_s()
    deadline = time.time() + wait_s
    while True:
        try:
            client.stats()
            break
        except PSUnavailableError:
            if time.time() > deadline:
                raise SystemExit(f"PS tasks unreachable after {wait_s:.0f}s")
            time.sleep(0.5)
    logger.info("%s task %d = async worker %d/%d against ps=%s", task_type,
                task_index, worker_id, num_workers, ps_addrs)
    losses, staleness = worker_loop(worker_id, num_workers, ps_addrs, plan,
                                    spec)
    hist: dict[int, int] = {}
    for st in staleness:
        hist[st] = hist.get(st, 0) + 1
    logger.info(
        "worker %d done: loss %.4f -> %.4f over %d steps, staleness %s",
        worker_id, losses[0] if losses else float("nan"),
        losses[-1] if losses else float("nan"), len(losses),
        dict(sorted(hist.items())))
    return [{"worker": worker_id, "losses": losses,
             "staleness_hist": hist}]


def main(argv=None):
    """Run the role of ``--job`` (:func:`resolve_job`): train, and return
    the log records (the chief prints them); or the sidecar evaluator
    (:func:`run_evaluator`, its ``{step: metrics}``), the async parameter
    server (:func:`run_async_ps`, its records) or a task of a TF_CONFIG
    ps cluster (:func:`run_ps_cluster_task`), each chosen before any
    process group starts (``bootstrap`` would count the ps tasks into its
    world and wait for them).  A process group this call started is
    shut down at its end, and the goodput ledger it installed
    uninstalled."""
    args = parse_args(argv)
    job, ps_cluster = resolve_job(args)
    if job == "evaluator":
        return run_evaluator(args)
    if job == "async-ps":
        return run_async_ps(args)
    if job == "ps-cluster":
        return run_ps_cluster_task(args, *ps_cluster)
    check_flags(args)
    # the goodput ledger FIRST, so that setup books as `init`; it reloads
    # a prior <logdir>/goodput.json, so a restarted run keeps one ledger
    ledger = None
    if args.goodput:
        ledger = obs.GoodputLedger(
            os.path.join(args.logdir, "goodput.json") if args.logdir
            else None).install()
    started = not torch.distributed.is_initialized()
    try:
        records = _train(args)
    except SystemExit:
        raise
    except BaseException:
        if ledger is not None:
            # the crash path: stamp the last heartbeat, leave the
            # generation open (a restart merges it as died mid-flight)
            ledger.heartbeat()
        raise
    finally:
        if started:
            bootstrap.shutdown()
        if ledger is not None and obs.goodput.default_ledger() is ledger:
            obs.goodput.install_ledger(None)
    if ledger is not None:
        # a preemption closed the generation as "preempted" already
        ledger.close(ended="clean")
    return records


def _train(args) -> list[dict]:
    if args.deterministic:
        enable_determinism()  # before the first cuBLAS call
    checkpointer = CheckpointManager(args.checkpoint_dir) \
        if args.checkpoint_dir else None
    feed = DataServiceFeed(args) if args.data_service else None
    prefit = None
    if feed is not None and args.logdir and not args.no_trace:
        # the client's epoch handshake (its spans, the dispatcher's and the
        # workers') runs when build() makes it, before the Trainer's own
        # recorder exists: this one takes them (train.py:1228-1240)
        prefit = obs.TraceRecorder(
            os.path.join(args.logdir, "trace.jsonl")).install()
    try:
        return _fit(args, checkpointer, feed)
    finally:
        if feed is not None:  # the run's workers end with it, not later
            feed.stop()
        if prefit is not None:
            prefit.uninstall()
            prefit.close()


def _fit(args, checkpointer, feed) -> list[dict]:
    wl, state, step, batches = build(args, checkpointer, feed=feed)
    mesh, _ = bootstrap_mesh(args)  # the mesh build() made
    group = {"group": mesh} if mesh is not None else {}
    eval_step = make_eval_step(wl.eval_fn(state.model, **group), mesh)
    eval_ctx = current_input_context(wl.global_batch_size, mesh)
    # the eval stream (seed + 999, as train.py draws it, or one pass over
    # the eval records): each rank reads its share of every global batch
    records = bool(args.eval_data_dir or args.data_dir)

    def eval_source():
        if records:
            return record_eval_source(args, eval_ctx, mesh)
        return wl.input_fn(eval_ctx, args.seed + 999)

    eval_iter_fn = (lambda: device_iter(args, eval_source(),
                                        state.model.device)) \
        if args.eval_every else None
    # SIGTERM (a preemption notice) -> a save at the next step boundary on
    # every rank, then a clean stop; the rerun resumes from that step
    preemption = PreemptionHandler(
        checkpointer, mesh=mesh.world if mesh is not None else None) \
        if checkpointer else None
    config = TrainerConfig(
        total_steps=args.steps, log_every=args.log_every,
        eval_every=args.eval_every, eval_steps=0 if records else EVAL_STEPS,
        checkpoint_every=args.checkpoint_every,
        steps_per_call=args.steps_per_call,
        input_prebundled=args.steps_per_call > 1,
        global_batch_size=wl.global_batch_size, logdir=args.logdir,
        profile_dir=args.profile_dir, profile_start=args.profile_start,
        profile_steps=args.profile_steps, auto_profile=args.auto_profile,
        max_captures=args.max_captures,
        capture_cooldown_s=args.capture_cooldown,
        watchdog_timeout=args.watchdog_timeout,
        target_metric=args.target_metric, target_value=args.target_value,
        target_mode=args.target_mode, trace=not args.no_trace,
        flops_per_step=args.flops_per_step,
        zero_stage=1 if state.zero is not None else 0, quant=args.quant,
        overlap_buckets=len(state.overlap.buckets)
        if state.overlap is not None else 0,
        overlap_coverage=state.overlap.coverage
        if state.overlap is not None else 0.0,
        anomaly_detection=not args.no_anomaly_detection,
        status_port=args.status_port, status_host=args.status_host,
        flight_recorder=args.flight_recorder,
        dynamics_every=args.dynamics_every,
        **pipeline_fields(state.model))
    if not config.flops_per_step and args.estimate_flops != "off":
        if wl.name.startswith(("gpt", "lm_")):
            # the whole model's parameters (a model rank holds shards, a
            # pipe rank its stage's blocks), its flops shared by every
            # device: replicas x model ranks x stages
            whole = GPTLM if mesh is not None and mesh.shape["pipe"] > 1 \
                else wl.model_cls
            per_token, _ = flops_per_token(
                whole(wl.cfg, device="meta"), wl.cfg, wl.seq_len)
            ranks = 1 if mesh is None else \
                replica_count(mesh) * mesh.shape["model"] * mesh.shape["pipe"]
            config.flops_per_step = (per_token * wl.global_batch_size
                                     * wl.seq_len / ranks)
        elif args.estimate_flops == "on":
            step = _counting_first_step(step, config)
    printer = _PrintRecords(wl, bootstrap.is_chief())
    dynamics = None
    if args.dynamics_every > 0:
        # every rank holds the same rows (the stats read the summed
        # gradients); the chief writes them
        dynamics = obs.DynamicsMonitor(
            args.dynamics_every,
            logdir=args.logdir if bootstrap.is_chief() else None,
            loss_fn=wl.loss_fn(state.model, **group),
            tap_fn=make_nan_taps(state.model), log_every=args.log_every,
            steps_per_call=args.steps_per_call,
            modules=dynamics_modules(wl.cfg, state.model), mesh=mesh)
        step = dynamics.wrap_train_step(step)
        logger.info("dynamics: module telemetry every %d step(s) -> "
                    "%s/dynamics.jsonl", args.dynamics_every, args.logdir)
    try:
        with Trainer(step, config, eval_step=eval_step,
                     checkpointer=checkpointer, preemption=preemption,
                     callbacks=[cb for cb in (printer, dynamics)
                                if cb is not None]) as trainer:
            planes = _Planes(args, trainer, dynamics, feed)
            try:
                trainer.fit(state, batches, eval_iter_fn=eval_iter_fn)
            finally:
                planes.stop()
    finally:
        if preemption is not None:
            preemption.uninstall()
    return printer.records


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    main(sys.argv[1:])
