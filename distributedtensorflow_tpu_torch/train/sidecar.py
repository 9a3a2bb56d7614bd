"""Sidecar evaluator: a dedicated evaluation task outside the training job.

Twin of ``distributedtensorflow_tpu/train/sidecar.py``: the ``evaluator``
task of the ``tf.distribute`` multi-worker convention, which TF_CONFIG
may declare outside the training cluster and which runs Keras's
sidecar-evaluation loop: poll the checkpoint directory, evaluate each new
checkpoint, write metrics.

The evaluator restores into a template state of its own (one process,
one device): a checkpoint of a model split over ``model``, ``expert`` or
``pipe`` is saved whole, and ZeRO's chunked optimizer state is re-cut on
read by :func:`..parallel.zero.restore_step_zero`, so a ``--zero``
trainer at any replica count and this evaluator interoperate.  The eval
step is the one ``train.make_eval_step`` builds for inline eval.

Run it with ``train_torch.py --job evaluator`` (chosen by itself when
TF_CONFIG says ``task.type == "evaluator"``).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Iterable

from .. import obs
from ..checkpoint.integrity import CheckpointCorruptError
from ..parallel.zero import restore_step_zero
from ..utils.metrics import MetricWriter
from .state import TrainState
from .trainer import weighted_evaluate

logger = logging.getLogger(__name__)


class SidecarEvaluator:
    """Poll a checkpoint directory; evaluate every new checkpoint.

    ``eval_iter_fn`` returns a fresh (finite or bounded) eval iterator per
    evaluation.  Evaluation always targets the *newest* checkpoint: if the
    trainer saved several while one eval ran, the ones in between are
    skipped (the reference sidecar's catch-up behavior).  Each checkpoint
    is restored in place into ``state_template``, whose model
    ``eval_step`` evaluates.
    """

    def __init__(
        self,
        checkpointer,  # checkpoint.CheckpointManager on the TRAINING job's dir
        eval_step: Callable[[TrainState, dict], dict],
        eval_iter_fn: Callable[[], Iterable[dict]],
        state_template: TrainState,
        *,
        eval_steps: int = 0,  # <=0: consume the whole iterator
        poll_interval_s: float = 10.0,
        max_evaluations: int | None = None,  # None = until stop conditions
        stop_after_step: int | None = None,  # evaluated step >= this -> done
        idle_timeout_s: float | None = None,  # no new ckpt for this long -> done
        logdir: str | None = None,
    ):
        self.checkpointer = checkpointer
        self.eval_step = eval_step
        self.eval_iter_fn = eval_iter_fn
        self.state_template = state_template
        self.eval_steps = eval_steps
        self.poll_interval_s = poll_interval_s
        self.max_evaluations = max_evaluations
        self.stop_after_step = stop_after_step
        self.idle_timeout_s = idle_timeout_s
        self.writer = MetricWriter(logdir)
        self.history: dict[int, dict] = {}  # step -> metrics

    def _evaluate_state(self, step: int, state) -> dict:
        with obs.span("sidecar_eval"):
            metrics = weighted_evaluate(
                self.eval_step, state, self.eval_iter_fn(),
                max_steps=self.eval_steps,
            )
        obs.counter(
            "sidecar_evaluations_total", "checkpoints evaluated"
        ).inc()
        self.history[step] = metrics
        self.writer.write(step, {f"eval/{k}": v for k, v in metrics.items()})
        logger.info(
            "sidecar: step %d %s", step,
            " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items())),
        )
        return metrics

    def run(self) -> dict[int, dict]:
        """Evaluate until a stop condition; returns {step: metrics}."""
        last_evaluated = -1
        last_new_ckpt_t = time.monotonic()
        try:
            while True:
                # A live writer's commit is several files: a step can be
                # listed before its manifest lands, so a restore can raise
                # mid-race.  A polling reader treats that as "nothing new
                # yet" and FALLS THROUGH to the idle check, so a broken
                # directory is bounded by idle_timeout_s instead of
                # retried forever.  Only the checkpoint reads are guarded;
                # evaluation and metric writing must fail loudly.
                step = state = None
                try:
                    self.checkpointer.reload()  # other-process writes
                    step = self.checkpointer.latest_step()
                    if step is not None and step > last_evaluated:
                        # the trainer may save --zero-chunked optimizer
                        # state at another degree than this template's:
                        # restore_step_zero re-cuts it instead of
                        # mistaking the shapes for corruption
                        state, _ = restore_step_zero(
                            self.checkpointer, step, self.state_template
                        )
                except OSError as e:
                    logger.info(
                        "sidecar: checkpoint not fully visible (%s); retry",
                        e,
                    )
                except CheckpointCorruptError as e:
                    # a torn or corrupt checkpoint mid-poll is the same
                    # "nothing evaluable yet": the trainer may still be
                    # writing, or a later poll sees a newer good step;
                    # either way bounded by idle_timeout_s
                    logger.warning(
                        "sidecar: checkpoint step %s failed verification "
                        "(%s); retry", step, e,
                    )
                if state is not None:
                    self._evaluate_state(step, state)
                    last_evaluated = step
                    last_new_ckpt_t = time.monotonic()
                    if (
                        self.max_evaluations is not None
                        and len(self.history) >= self.max_evaluations
                    ):
                        logger.info("sidecar: max_evaluations reached")
                        return self.history
                    if (
                        self.stop_after_step is not None
                        and step >= self.stop_after_step
                    ):
                        logger.info("sidecar: final step %d evaluated", step)
                        return self.history
                    continue  # a newer checkpoint may already exist
                if (
                    self.idle_timeout_s is not None
                    and time.monotonic() - last_new_ckpt_t > self.idle_timeout_s
                ):
                    logger.info(
                        "sidecar: no new checkpoint for %.0fs; stopping",
                        self.idle_timeout_s,
                    )
                    return self.history
                time.sleep(self.poll_interval_s)
        finally:
            self.writer.close()
