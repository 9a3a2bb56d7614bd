"""Supervised training: bounded-retry restarts around ``Trainer.fit``.

Twin of ``distributedtensorflow_tpu/resilience/supervisor.py``: the same
loop and the same table.

1. **classify** the failure (:func:`classify_failure`, the same rule
   order): chaos faults carry their kind; a coordinator worker death
   (the port's ``ClosureAborted``/``WorkerUnavailableError``) is
   ``worker_crash``; a fired hang watchdog or a ``DataStallFault`` is
   ``data_stall``; a NaN-loss anomaly (a callback that stops the fit) is
   ``nan_loss``; a consumed preemption notice is ``preemption``;
2. **restore** the newest *verified* checkpoint
   (``parallel.zero.restore_latest_zero``: corrupt steps are rejected and
   fallen back past, a checkpoint of another ZeRO layout is re-cut; a NaN
   restores from strictly *before* the poisoned step);
3. **re-enter** ``fit`` after an exponential backoff (base x 2^attempt,
   clamped), the input rebuilt at the resumed step;
4. **escalate** once the budget is spent: :class:`RestartBudgetExhausted`
   with the failure history, which ``train_torch.py`` turns into exit
   code 3 (and unrecovered injected faults into 4).

Every restart emits a ``restart`` flight event and a
``supervisor_restarts_total{kind=}`` count, books its classification and
backoff into the goodput ``badput_restart`` bucket (the restore books
under ``checkpoint_restore``), and sets ``trainer.supervisor_status``
(``/statusz``'s ``supervisor``).

What differs from JAX: the port's step updates the state in place
(``TrainState.apply_gradients``), and the Trainer, a k-step CUDA graph,
ZeRO's sharder and the overlap's hooks hold its tensors.  So a restart
restores *into the live state* (the manager's restore copies into it),
where JAX restores into a fresh template because the failed fit's state
was donated; a cold restart (no checkpoint, or every step rejected)
calls ``reinit_fn(state)``, which re-initialises the live state in place
(``train_torch.py``: the model from ``--seed``, the optimizer's state
reset, step 0).  The checkpoint manager commits a save on a writer
thread, so a restart first waits for the save in flight: the step was
accepted, and JAX's orbax manager tracks a step from the start of its
save.  :meth:`Supervisor.run` takes no ``rng``: the port's ``fit`` takes
none.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Iterable

from .. import obs
from ..parallel.coordinator import ClosureAborted, WorkerUnavailableError
from . import chaos as chaos_lib

logger = logging.getLogger(__name__)

__all__ = [
    "RestartBudgetExhausted",
    "Supervisor",
    "SupervisorConfig",
    "classify_failure",
]

_M_RESTARTS = obs.counter(
    "supervisor_restarts_total",
    "supervised in-process restarts, by failure kind",
)

#: Failure kinds that must NOT be retried: restarting cannot help.
NONRETRYABLE_KINDS = frozenset({"data_exhausted"})


def classify_failure(
    exc: BaseException | None = None,
    *,
    preempted: bool = False,
    nan_anomaly: bool = False,
    watchdog_fired: bool = False,
    resize_draining: bool = False,
) -> str:
    """The failure-classification table (module docstring, rule order):
    chaos faults carry their kind; known exception types map to kinds; a
    fired watchdog turns an otherwise-unknown failure into ``data_stall``;
    everything else is ``unknown`` (still retried — an unknown crash is
    exactly what a restart policy is for).

    ``resize_draining``: a timeout while the ElasticController is draining
    the fit is the DRAIN wedging, not a dead input pipeline — classifying
    it ``data_stall`` restarted from the wrong state (and re-ran the
    resize that just wedged).  ``resize_drain`` is retryable and the
    restart path abandons the resize, falling back to the pre-resize
    checkpoint."""
    if preempted:
        return "preemption"
    if exc is None:
        return "nan_loss" if nan_anomaly else "unknown"
    if isinstance(exc, chaos_lib.InjectedFault):
        return exc.kind
    if isinstance(exc, (WorkerUnavailableError, ClosureAborted)):
        return "worker_crash"
    if isinstance(exc, StopIteration):
        return "data_exhausted"
    if isinstance(exc, TimeoutError):
        return "resize_drain" if resize_draining else "data_stall"
    if isinstance(exc, FloatingPointError):
        return "nan_loss"
    if watchdog_fired:
        return "resize_drain" if resize_draining else "data_stall"
    return "unknown"


class RestartBudgetExhausted(RuntimeError):
    """The retry budget ran out; ``failures`` is the per-attempt history
    (kind, step, error) and ``last_exception`` the final straw (when the
    final failure was exception-shaped)."""

    def __init__(self, message: str, *, failures: list[dict],
                 last_exception: BaseException | None = None):
        super().__init__(message)
        self.failures = failures
        self.last_exception = last_exception


@dataclasses.dataclass
class SupervisorConfig:
    #: Total in-process restarts allowed before escalating.
    max_restarts: int = 3
    #: Backoff before restart N (1-based) is ``base * factor**(N-1)``,
    #: clamped to ``backoff_max_s``.
    backoff_base_s: float = 1.0
    backoff_factor: float = 2.0
    backoff_max_s: float = 60.0
    #: Resume (rather than exit) after a preemption-shaped stop — the
    #: in-process analogue of the launcher restarting the job.  Real
    #: cluster preemptions kill the process anyway; this path serves
    #: synthetic/chaos preemptions and schedulers that rescind notices.
    resume_on_preemption: bool = True

    def backoff_s(self, attempt: int) -> float:
        """Clamped exponential backoff before restart ``attempt``
        (1-based)."""
        return min(
            self.backoff_base_s * (self.backoff_factor ** max(attempt - 1, 0)),
            self.backoff_max_s,
        )


class _NanWatch:
    """Trainer callback: a non-finite-loss anomaly ends the fit (the
    anomaly hook itself must never raise — the Watchdog convention — so it
    stops the loop via ``stop_training`` and the Supervisor reads the flag
    after ``fit`` returns)."""

    def __init__(self):
        self.anomaly = None

    def reset(self) -> None:
        self.anomaly = None

    def tripped(self) -> bool:
        return self.anomaly is not None

    # Callback surface (duck-typed; only on_anomaly matters here).
    def on_fit_begin(self, trainer, state) -> None: ...
    def on_step_end(self, trainer, step, state, metrics) -> None: ...
    def on_log(self, trainer, step, record) -> None: ...
    def on_eval_end(self, trainer, step, state, eval_metrics) -> None: ...
    def on_checkpoint(self, trainer, step, state) -> None: ...
    def on_fit_end(self, trainer, state) -> None: ...

    def on_anomaly(self, trainer, anomaly) -> None:
        if anomaly.kind == "non_finite_loss" and self.anomaly is None:
            self.anomaly = anomaly
            logger.error(
                "supervisor: NaN loss at step %d — stopping the fit for a "
                "restore-and-restart", anomaly.step,
            )
            trainer.stop_training = True


class Supervisor:
    """Wraps a Trainer's ``fit`` in the restart policy.

    ``make_train_iter(start_step)`` must return a fresh train iterator
    positioned after ``start_step`` consumed batches (``skip_batches``);
    it is called once per (re)start.  A restart restores into the live
    state; ``reinit_fn(state)`` re-initialises it in place for a cold
    restart (no usable checkpoint; without it the state is resumed as it
    stands).  ``chaos`` (a :class:`~.chaos.ChaosInjector`) gets its
    injected faults paired with ``recovered`` rows after each successful
    restart.  ``elastic``: a resize controller, none in the port yet.
    """

    def __init__(
        self,
        trainer,
        *,
        make_train_iter: Callable[[int], Iterable],
        reinit_fn: Callable[[Any], Any] | None = None,
        eval_iter_fn: Callable[[], Iterable] | None = None,
        config: SupervisorConfig | None = None,
        chaos: chaos_lib.ChaosInjector | None = None,
        elastic=None,
    ):
        self.trainer = trainer
        self.config = config or SupervisorConfig()
        self._make_train_iter = make_train_iter
        self._reinit_fn = reinit_fn
        self._eval_iter_fn = eval_iter_fn
        self._chaos = chaos
        #: A resize controller (or None): drained resizes are performed
        #: inside the supervised loop, so a mid-resize crash falls into
        #: the same classify -> restore -> re-enter path.
        self._elastic = elastic
        self._nan_watch = _NanWatch()
        trainer.callbacks.append(self._nan_watch)
        #: Per-restart history: {"kind", "attempt", "resumed_step",
        #: "backoff_s", "error"}.
        self.restarts: list[dict] = []

    # -- status --------------------------------------------------------------

    def status(self) -> dict:
        return {
            "restarts": len(self.restarts),
            "max_restarts": self.config.max_restarts,
            "last_failure": (
                self.restarts[-1]["kind"] if self.restarts else None
            ),
            "last_resumed_step": (
                self.restarts[-1]["resumed_step"] if self.restarts else None
            ),
        }

    def _publish_status(self) -> None:
        self.trainer.supervisor_status = self.status()

    # -- the restart loop ----------------------------------------------------

    def run(self, state) -> Any:
        """Drive ``fit`` to completion under the restart policy; returns
        the final state, or raises :class:`RestartBudgetExhausted` /
        a non-retryable failure."""
        trainer = self.trainer
        cfg = self.config
        failures: list[dict] = []
        self._publish_status()
        while True:
            self._nan_watch.reset()
            exc: BaseException | None = None
            try:
                it = self._make_train_iter(int(state.step))
                state = trainer.fit(state, it,
                                    eval_iter_fn=self._eval_iter_fn)
            except (KeyboardInterrupt, SystemExit):
                raise  # operator intent / clean exits pass through
            except BaseException as e:  # noqa: BLE001 — classified below
                exc = e
            t_fail = time.time()
            step_now = int(getattr(state, "step", 0)) if exc is None else None
            total = trainer.config.total_steps
            if exc is None:
                preempted = bool(getattr(trainer, "preempted", False))
                if preempted and cfg.resume_on_preemption \
                        and int(state.step) < total:
                    kind = "preemption"
                elif self._nan_watch.tripped() and int(state.step) < total:
                    kind = "nan_loss"
                elif self._elastic is not None and self._elastic \
                        .should_perform(int(state.step), total):
                    # The fit drained for a resize: re-form the mesh and
                    # rechunk INSIDE the supervised loop, so a mid-resize
                    # crash is classified/restored like any other failure
                    # (abandon() in _restart falls back to the pre-resize
                    # checkpoint at the old size).
                    try:
                        state = self._elastic.perform(state)
                    except (KeyboardInterrupt, SystemExit):
                        raise
                    except BaseException as e:  # noqa: BLE001
                        exc = e
                        t_fail = time.time()
                        kind = classify_failure(e)
                        step_now = None
                    else:
                        continue
                else:
                    # Done: target reached, total_steps hit, or a
                    # user-requested stop — none of which is a failure.
                    self._publish_status()
                    return state
            else:
                kind = classify_failure(
                    exc,
                    watchdog_fired=bool(
                        getattr(trainer, "watchdog_fired", False)
                    ),
                    resize_draining=bool(
                        self._elastic is not None and self._elastic.draining
                    ),
                )
            failures.append({
                "kind": kind,
                "step": step_now,
                "error": (repr(exc)[:300] if exc is not None else None),
            })
            logger.error(
                "supervisor: fit failed (%s)%s — %d/%d restarts used",
                kind, f": {exc!r}" if exc else "", len(self.restarts),
                cfg.max_restarts,
            )
            if kind in NONRETRYABLE_KINDS:
                logger.error("supervisor: %s is not retryable; escalating",
                             kind)
                if exc is not None:
                    raise exc
                raise RestartBudgetExhausted(
                    f"non-retryable failure: {kind}", failures=failures,
                )
            if len(self.restarts) >= cfg.max_restarts:
                obs.record_event(
                    "supervisor_giving_up", restarts=len(self.restarts),
                    failure=kind,
                )
                raise RestartBudgetExhausted(
                    f"retry budget exhausted after {len(self.restarts)} "
                    f"restart(s); final failure: {kind}",
                    failures=failures, last_exception=exc,
                )
            state = self._restart(state, kind, exc, t_fail)

    def _restart(self, state, kind: str, exc: BaseException | None,
                 t_fail: float):
        """One restart: backoff, restore from the newest verified
        checkpoint, book the badput, pair chaos recoveries; returns the
        state to resume from."""
        trainer = self.trainer
        cfg = self.config
        attempt = len(self.restarts) + 1
        # A resize in flight does NOT survive a restart: close its window
        # as failed and drop the pending request BEFORE booking the
        # restart badput (the resize window's residual stops here), so
        # the restore below lands on the pre-resize checkpoint and the
        # resize is not re-run.
        if self._elastic is not None:
            self._elastic.abandon(reason=kind)
        backoff = cfg.backoff_s(attempt)
        logger.warning(
            "supervisor: restart %d/%d after %s — backing off %.2fs",
            attempt, cfg.max_restarts, kind, backoff,
        )
        if backoff > 0:
            time.sleep(backoff)
        # Book classification + backoff as badput_restart BEFORE the
        # restore starts: the restore's own span already books under
        # checkpoint_restore, and the goodput buckets must stay exclusive.
        obs.goodput.note_restart(time.time() - t_fail)
        before_step = None
        if kind == "nan_loss":
            # Resume from BEFORE the poisoned step — the stop-save the
            # trainer force-wrote on the way out is downstream of the NaN.
            if self._nan_watch.anomaly is not None:
                before_step = self._nan_watch.anomaly.step
            else:
                # Exception-shaped NaN (a FloatingPointError raised by
                # the step): the NaN surfaced during the step AFTER
                # the last completed one, so a checkpoint at _last_step
                # itself still predates it.
                last = getattr(trainer, "_last_step", None)
                if last is not None:
                    before_step = int(last) + 1
        rejected_steps: list[int] = []
        resumed = None
        if trainer.checkpointer is not None:
            # the save in flight was accepted: an in-process restart finds
            # it committed (JAX's orbax manager tracks a step from the
            # start of its save; the port's commits on a writer thread)
            self._wait_for_save(trainer.checkpointer)
            # into the live state: the Trainer, a CUDA graph, ZeRO's
            # sharder and the overlap's hooks hold its tensors
            if getattr(state, "optimizer", None) is not None:
                # layout-aware: a checkpoint of another ZeRO degree (or
                # none) is re-cut, not rejected as corrupt
                from ..parallel.zero import restore_latest_zero  # noqa: PLC0415

                resumed = restore_latest_zero(
                    trainer.checkpointer, state, before_step=before_step
                )
            else:
                resumed = trainer.checkpointer.restore_latest(
                    state, before_step=before_step
                )
            report = getattr(trainer.checkpointer, "last_restore_report",
                             None) or {}
            rejected_steps = [
                r.get("step") for r in report.get("rejected", ())
            ]
            if resumed is None:
                resumed = self._cold(state)
                logger.warning(
                    "supervisor: no usable checkpoint%s; cold restart from "
                    "step %d", f" below step {before_step}" if before_step
                    else "", int(resumed.step),
                )
        else:
            resumed = self._cold(state)
        resumed_step = int(getattr(resumed, "step", 0))
        # Re-arm consumed one-shot machinery before the next fit.
        clear = getattr(trainer, "clear_preempted", None)
        if clear is not None:
            clear()
        _M_RESTARTS.inc(kind=kind)
        # NaN-provenance hint (obs/dynamics.py): a nan_loss restart that
        # knows WHICH module went bad says so — "restored from step K"
        # becomes "module h3 produced the first non-finite at step K".
        prov_fields = {}
        if kind == "nan_loss":
            try:
                from ..obs import dynamics as dynlib  # noqa: PLC0415

                prov = dynlib.last_provenance()
            except Exception:  # pragma: no cover — hint only, never fatal
                prov = None
            if prov and prov.get("module"):
                prov_fields = {
                    "nan_module": prov["module"],
                    "provenance_step": prov.get("step"),
                }
                logger.warning(
                    "supervisor: nan provenance — module %r produced the "
                    "first non-finite value at step %s (via %s)",
                    prov["module"], prov.get("step"), prov.get("method"),
                )
        obs.record_event(
            "restart", step=resumed_step, failure=kind, attempt=attempt,
            backoff_s=round(backoff, 3),
            rejected_checkpoints=len(rejected_steps),
            **prov_fields,
        )
        self.restarts.append({
            "kind": kind, "attempt": attempt, "resumed_step": resumed_step,
            "backoff_s": backoff,
            "error": repr(exc)[:300] if exc is not None else None,
        })
        if self._chaos is not None:
            self._chaos.mark_recovered(
                resumed_step=resumed_step, attempt=attempt,
                rejected_steps=rejected_steps,
            )
        self._publish_status()
        logger.warning(
            "supervisor: resuming from step %d (restart %d/%d)",
            resumed_step, attempt, cfg.max_restarts,
        )
        return resumed

    @staticmethod
    def _wait_for_save(checkpointer) -> None:
        """Wait for the checkpointer's save in flight; a failed one is
        logged (its step is not committed, so the restore passes it)."""
        wait = getattr(checkpointer, "wait", None)
        if wait is None:
            return
        try:
            wait()
        except Exception:
            logger.exception("supervisor: the checkpoint save in flight "
                             "failed; restoring from the committed steps")

    def _cold(self, state):
        """The state a cold restart resumes from: ``reinit_fn(state)``
        (the live state re-initialised in place), or the state as it
        stands without one (the caller manages it)."""
        return self._reinit_fn(state) if self._reinit_fn is not None \
            else state
