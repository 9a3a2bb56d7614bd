"""Trainer: the fit loop around the train step, and the telemetry it
carries.

Twin of ``distributedtensorflow_tpu/train/trainer.py``: ``TrainerConfig``
(``:32-173``), ``Callback`` (``:175``), ``Trainer`` (``:208-1030``; its
bundled fit loop ``_fit_loop``, ``:555-680``),
``device_memory_stats`` (``:1032``) and ``weighted_evaluate``
(``:1056``).  The loop is plain host Python, the same on one device or
one rank of a data-parallel mesh: periodic logging, eval, checkpoints and
the preemption check, the span breakdown (``t_data``/``t_dispatch``/
``t_host``), the registry, the anomaly detector, the flight recorder, the
goodput ledger's boundaries, memory and MFU fields, the reactive profiler
and the status server.

What differs from JAX:

- The step is the port's own, ``step(state, batch) -> (state,
  metrics)``: dropout's bits come from ``train.engine.step_seed``, so
  :meth:`Trainer.fit` takes no key.
- The host runs ahead of the card, as JAX's dispatch does: ``metrics``
  stay device tensors until a log boundary reads them (the
  ``host_block`` span), so ``t_dispatch`` is the launch and ``t_host``
  the wait for the device.  The watchdog pings on dispatch.
- ``steps_per_call`` > 1 takes a multi-step function
  (``train.engine.make_multi_train_step``: on the card one replayed CUDA
  graph of k steps) and k stacked batches a call (``input_prebundled``:
  the iterator yields them, as ``data.Prefetcher(bundle=k)`` does).
- The last step (``total_steps``) is a log boundary too, so a run whose
  length is not a multiple of ``log_every`` reports its last loss.
- ``Callback.on_log`` is the port's addition: it hands each log record
  to callers that print it (``train_torch.py``'s one JSON line a log
  step).
- Eval over a mesh: the eval step sums the ranks' shares of each metric
  (``train.engine.make_eval_step``), so each batch's metrics are the
  global eval batch's, and :func:`weighted_evaluate` weights the batches
  by their rows (a rank's share, the same fraction of every batch).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch

from .. import obs
from ..data.adaptive import input_record_fields
from ..parallel import bootstrap
from ..utils.metrics import MetricWriter, ThroughputMeter
from .state import TrainState

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int
    log_every: int = 50
    eval_every: int = 0  # 0 = no eval
    eval_steps: int = 10
    checkpoint_every: int = 0  # 0 = no checkpointing
    #: Optimizer steps a call of the train step (a multi-step function
    #: for k > 1); hooks fire when a call crosses their period.
    steps_per_call: int = 1
    #: The input yields (steps_per_call, B, ...) bundles (a short tail is
    #: trained, not dropped).
    input_prebundled: bool = False
    global_batch_size: int = 0
    logdir: str | None = None
    # Profiling window: a torch.profiler trace of steps [profile_start,
    # profile_start + profile_steps) into profile_dir, routed through the
    # CaptureEngine (obs.capture) as its "static" trigger.
    profile_dir: str | None = None
    profile_start: int = 10
    profile_steps: int = 5
    # Reactive profiling (obs.CaptureEngine): arm a capture of the next
    # profile_steps steps when the anomaly detector flags a step-time
    # regression, or — over ranks — the t_step spread passes
    # capture_spread_factor x the median.  max_captures bounds the run's
    # captures; capture_cooldown_s spaces triggered ones (manual
    # /profilez requests skip the cooldown but not the budget).
    auto_profile: bool = False
    max_captures: int = 8
    capture_cooldown_s: float = 120.0
    capture_spread_factor: float = 3.0
    # On-demand captures only (train_torch.py's --profiler-port, whose
    # server arms them): the engine exists without a status server.
    capture_on_demand: bool = False
    # Informational stamps of modes built into the state and the step
    # elsewhere (ZeRO, quantized compute, the overlapped gradient sync and
    # the pipeline schedule, which train_torch.py sets): set, they stamp
    # every metric record and /statusz as in JAX.
    zero_stage: int = 0
    quant: str = "none"
    overlap_buckets: int = 0
    overlap_coverage: float = 0.0
    pipeline_schedule: str = "none"
    pipeline_stages: int = 0
    pipeline_microbatches: int = 0
    pipeline_virtual: int = 1
    pipeline_bubble: float = 0.0
    # Hang watchdog: dump all thread stacks if no step is dispatched for
    # this many seconds.  0 disables.
    watchdog_timeout: float = 0.0
    # Accuracy gate: stop as soon as eval metric `target_metric` reaches
    # `target_value` ("max": metric >= value; "min": metric <= value).
    target_metric: str | None = None
    target_value: float | None = None
    target_mode: str = "max"
    # Span tracing: <logdir>/trace.jsonl and the per-step breakdown
    # fields (t_data/t_step/f_data/...) in every train record.
    trace: bool = True
    # This device's model FLOPs per optimizer step: enables the mfu
    # fields (obs.mfu; a card of a known kind only).  0 = no MFU.
    flops_per_step: float = 0.0
    # Streaming anomaly detection at log boundaries.
    anomaly_detection: bool = True
    # Live introspection server (obs.StatusServer) on this port (0 =
    # ephemeral; the bound port is trainer.status_server.port).  None
    # disables.  Loopback by default: /threadz and /flightz leak paths.
    status_port: int | None = None
    status_host: str = "127.0.0.1"
    # Flight recorder: a ring of structured events dumped to
    # <logdir>/flight.jsonl (flight.<rank>.jsonl off the chief) on
    # watchdog timeout, exception, anomaly, preemption and fit exit.
    flight_recorder: bool = False
    flight_capacity: int = 2048
    # Training-dynamics telemetry (obs.dynamics): the cadence is in the
    # train step (engine dynamics_every) and the DynamicsMonitor callback
    # books the stats; > 0 stamps the cadence into /statusz so a live run
    # advertises which steps carry the per-module statistics.
    dynamics_every: int = 0

    def __post_init__(self):
        if self.steps_per_call < 1:
            raise ValueError(
                f"steps_per_call must be >= 1, got {self.steps_per_call}")
        if self.dynamics_every < 0:
            raise ValueError(
                f"dynamics_every must be >= 0, got {self.dynamics_every}")
        # Fail a dead-on-arrival gate at setup, not after the first eval.
        if self.target_metric:
            if self.target_value is None:
                raise ValueError("target_metric set but target_value is None")
            if not self.eval_every:
                raise ValueError(
                    "target_metric set but eval_every is 0 — the gate can "
                    "never fire")
        if self.target_mode not in ("max", "min"):
            raise ValueError(
                f"target_mode must be max|min, got {self.target_mode!r}")


class Callback:
    """Trainer extension hook (the Keras-callbacks analogue).  Subclass and
    override any subset; every method is a no-op by default.

    ``on_step_end`` fires once a step with the completed step count and
    that step's metrics (device tensors: ``float()`` waits for the card).
    Set ``trainer.stop_training = True`` from any hook to end the fit
    after the current step; the final checkpoint still saves.
    """

    def on_fit_begin(self, trainer: "Trainer", state) -> None: ...

    def on_step_end(self, trainer: "Trainer", step: int, state,
                    metrics: dict) -> None: ...

    def on_log(self, trainer: "Trainer", step: int, record: dict) -> None:
        """Fires at each log boundary with the record written to
        ``metrics.jsonl`` (host floats)."""
        ...

    def on_eval_end(self, trainer: "Trainer", step: int, state,
                    eval_metrics: dict) -> None: ...

    def on_checkpoint(self, trainer: "Trainer", step: int, state) -> None: ...

    def on_anomaly(self, trainer: "Trainer", anomaly) -> None:
        """Fires per detected :class:`~..obs.Anomaly`; exceptions are
        logged, never fatal to the fit."""
        ...

    def on_fit_end(self, trainer: "Trainer", state) -> None: ...


class Trainer:
    def __init__(
        self,
        train_step: Callable[[TrainState, dict], tuple[TrainState, dict]],
        config: TrainerConfig,
        *,
        eval_step: Callable[[TrainState, dict], dict] | None = None,
        checkpointer=None,  # checkpoint.CheckpointManager-compatible
        preemption=None,  # checkpoint.PreemptionHandler-compatible
        callbacks: list[Callback] | None = None,
    ):
        self.train_step = train_step
        self.eval_step = eval_step
        self.config = config
        self.checkpointer = checkpointer
        self.preemption = preemption
        self.callbacks = list(callbacks or [])
        #: Callbacks set this to end the fit after the current step.
        self.stop_training = False
        self.writer = MetricWriter(config.logdir)
        self.meter = ThroughputMeter(config.global_batch_size)
        #: Span recorder of the current fit (obs.TraceRecorder).
        self.tracer: obs.TraceRecorder | None = None
        #: Streaming anomaly detector, fed at log boundaries.
        self.anomaly_detector = (
            obs.AnomalyDetector(on_anomaly=self._record_anomaly)
            if config.anomaly_detection else None
        )
        self._anomaly_counter = obs.counter(
            "anomalies_total", "anomalies detected by kind")
        # Breakdown window clocks (reset at every log boundary).
        self._window_t0 = time.perf_counter()
        self._window_step0 = 0
        # Latest eval metrics, threaded into checkpointer.save() so a
        # keep-best manager works under the Trainer.
        self._last_eval_metrics: dict | None = None
        self._preempted = False
        #: The fit's hang watchdog while a fit is running.
        self.watchdog = None
        #: Whether the LAST fit's watchdog fired.
        self.watchdog_fired = False
        #: Set by ``resilience.Supervisor`` while it owns this trainer
        #: (``restarts``, ``max_restarts``, ``last_failure``, ...):
        #: /statusz shows it under ``supervisor``.
        self.supervisor_status: dict | None = None
        # Last log-boundary record + step: what /statusz and /healthz
        # report (plain reads; handlers never sync the device).
        self._last_record: dict = {}
        self._last_step = 0
        self._fit_t0: float | None = None
        self._state_bytes_fresh = False
        # Checkpoint state tracked here so /statusz does no storage I/O.
        self._ckpt_count = 0
        self._last_ckpt_step: int | None = None
        #: Flight recorder, installed as the process default so the
        #: engine's, checkpointer's and watchdog's markers land in it.
        #: The chief writes <logdir>/flight.jsonl, rank r flight.r.jsonl.
        self.flight: obs.FlightRecorder | None = None
        if config.flight_recorder:
            path = None
            if config.logdir is not None:
                idx = bootstrap.process_index()
                name = "flight.jsonl" if idx == 0 else f"flight.{idx}.jsonl"
                path = os.path.join(config.logdir, name)
            self.flight = obs.FlightRecorder(config.flight_capacity, path)
            obs.install_recorder(self.flight)
            self.flight.install_crash_hooks()
        #: Reactive profiler: owns every profiler window of the fit.
        self.capture: obs.CaptureEngine | None = None
        if (config.profile_dir or config.auto_profile
                or config.status_port is not None
                or config.capture_on_demand):
            self.capture = obs.CaptureEngine(
                config.logdir,
                max_captures=config.max_captures,
                cooldown_s=config.capture_cooldown_s,
                window_steps=config.profile_steps,
            )
            obs.capture.install_engine(self.capture)
        #: Live introspection server, alive for the trainer's lifetime.
        self.status_server: obs.StatusServer | None = None
        if config.status_port is not None:
            # a fixed port is offset by the rank so that every process of
            # a host stays probeable; 0 is ephemeral.  A failed bind only
            # warns: introspection must never kill the job it debugs.
            port = config.status_port
            if port:
                port += bootstrap.process_index()
            try:
                self.status_server = obs.StatusServer(
                    port,
                    host=config.status_host,
                    flight=self.flight,
                    capture=self.capture,
                    status_fn=self.status,
                    health_fn=self.health,
                ).start()
            except OSError:
                logger.exception(
                    "introspection server failed to bind %s:%d; "
                    "continuing without it", config.status_host, port)

    def fit(
        self,
        state: TrainState,
        train_iter: Iterable[dict],
        *,
        eval_iter_fn: Callable[[], Iterable[dict]] | None = None,
    ) -> TrainState:
        cfg = self.config
        it = iter(train_iter)
        # a fresh fit clears a prior run's early-stop request
        self.stop_training = False
        self.watchdog_fired = False
        self.meter.start()
        self._window_t0 = time.perf_counter()
        self._window_step0 = int(state.step)
        self._last_step = int(state.step)
        self._fit_t0 = time.time()
        if self.flight is not None:
            self.flight.record("fit_begin", step=int(state.step),
                               total_steps=cfg.total_steps)
        # the devices the status server's /memz reads, named on this thread
        obs.memory.set_local_devices(
            sorted({p.device for p in state.model.parameters()}, key=str))
        self._refresh_state_bytes(state)
        ledger = obs.goodput.default_ledger()
        if ledger is not None:  # close the goodput `init` window
            ledger.mark_fit_begin(int(state.step))
        watchdog = None
        if cfg.watchdog_timeout > 0:
            from ..utils.watchdog import Watchdog

            watchdog = Watchdog(cfg.watchdog_timeout,
                                flight_recorder=self.flight)
        self.watchdog = watchdog
        if cfg.trace:
            trace_path = (os.path.join(cfg.logdir, "trace.jsonl")
                          if cfg.logdir else None)
            self.tracer = obs.TraceRecorder(trace_path).install()
        fit_exc: BaseException | None = None
        try:
            try:
                for cb in self.callbacks:
                    cb.on_fit_begin(self, state)
                state = self._fit_loop(state, it, eval_iter_fn, watchdog)
            finally:
                if self.tracer is not None:
                    # early returns leave the last step row open: flush it
                    # so the final save's spans land unanchored
                    self.tracer.end_step()
                if watchdog is not None:
                    self.watchdog_fired = watchdog.fired
                    watchdog.stop()
                    self.watchdog = None
                close = getattr(train_iter, "close", None)
                if close is not None:
                    close()
            if self.checkpointer is not None and not self._preempted:
                # labelled with the step reached (an accuracy-gate stop must
                # not save under the total_steps slot); a preemption exit
                # force-saved inside the loop already
                self.checkpointer.save(int(state.step), state, force=True,
                                       metrics=self._ckpt_metrics())
                self.checkpointer.wait()
                self._ckpt_count += 1
                self._last_ckpt_step = int(state.step)
            for cb in self.callbacks:
                cb.on_fit_end(self, state)
            return state
        except BaseException as e:
            fit_exc = e
            raise
        finally:
            if self.tracer is not None:
                self.tracer.uninstall()
                self.tracer.close()
                self.tracer = None
            if self.flight is not None:
                # fit_end marks CLEAN exits only: a crashed fit ends on its
                # exception event
                if fit_exc is not None:
                    self.flight.record(
                        "exception", exc_type=type(fit_exc).__name__,
                        message=str(fit_exc)[:500])
                    self.flight.dump(reason=type(fit_exc).__name__)
                else:
                    self.flight.record("fit_end", step=int(state.step),
                                       preempted=self._preempted)
                    self.flight.dump()
            ledger = obs.goodput.default_ledger()
            if ledger is not None:
                # final-boundary flush; the entry point owns close(ended=)
                ledger.heartbeat(step=self._last_step)

    def close(self) -> None:
        """Release owned resources: the metric writer, the introspection
        server, the capture engine's and the flight recorder's process
        defaults and crash hooks.  Idempotent."""
        self.writer.close()
        obs.memory.set_train_state_bytes(None)
        obs.memory.set_local_devices(None)
        if self.status_server is not None:
            self.status_server.stop()
        if self.capture is not None:
            if obs.capture.default_engine() is self.capture:
                obs.capture.install_engine(None)
        if self.flight is not None:
            self.flight.uninstall_crash_hooks()
            if obs.default_recorder() is self.flight:
                obs.install_recorder(None)

    def __enter__(self) -> "Trainer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def preempted(self) -> bool:
        """Whether the last fit exited via the preemption save path."""
        return self._preempted

    def clear_preempted(self) -> None:
        """Re-arm after a supervised in-process resume: the next fit must
        not inherit the consumed notice (the handler's flag included)."""
        self._preempted = False
        if self.preemption is not None:
            reset = getattr(self.preemption, "reset", None)
            if reset is not None:
                reset()

    def _refresh_state_bytes(self, state) -> None:
        """Per-device parameter and optimizer-state bytes (/memz, gauges,
        record fields).  The optimizer creates its moments at its first
        step, so the breakdown is taken at fit begin and once more at the
        fit's first log boundary."""
        try:
            report: dict = obs.memory.state_bytes_report(state.model,
                                                         state.optimizer)
            if self.config.zero_stage:
                report["zero_stage"] = self.config.zero_stage
                if getattr(state, "zero", None) is not None:
                    report["zero_degree"] = state.zero.degree
            obs.memory.set_train_state_bytes(report)
        except Exception:
            logger.exception("train-state bytes accounting failed")

    def _record_anomaly(self, anomaly) -> None:
        """Default anomaly sink: log, count, trace, flight-record, fan out
        to callbacks (never fatal to the fit)."""
        logger.error("anomaly: %s", anomaly.message)
        self._anomaly_counter.inc(kind=anomaly.kind)
        if self.tracer is not None:
            self.tracer.write_event({
                "kind": "anomaly", "step": anomaly.step,
                "anomaly": anomaly.kind, "message": anomaly.message,
                "value": anomaly.value,
            })
        if self.flight is not None:  # records the event AND dumps the ring
            self.flight.record_anomaly(anomaly)
        if (self.capture is not None and self.config.auto_profile
                and anomaly.kind == "step_time_regression"):
            # a regression arms a capture of the very next steps
            self.capture.request("step_time_regression",
                                 reason=anomaly.message)
        for cb in self.callbacks:
            try:
                cb.on_anomaly(self, anomaly)
            except Exception:
                logger.exception("on_anomaly callback failed")

    def _ckpt_metrics(self, manager=None) -> dict | None:
        """Metrics to attach to a save through ``manager`` (default: the
        periodic checkpointer).  A keep-best manager needs its metric on
        every save: before the first eval (or when eval does not produce
        it) the worst possible score stands in."""
        manager = manager if manager is not None else self.checkpointer
        metrics = dict(self._last_eval_metrics or {})
        best_metric = getattr(manager, "best_metric", None)
        if best_metric is not None and best_metric not in metrics:
            worst = float("-inf") if getattr(
                manager, "best_mode", "max") == "max" else float("inf")
            if self._last_eval_metrics is not None:
                logger.warning(
                    "checkpoint keep-best metric %r missing from eval "
                    "metrics %s; saving with worst-possible score",
                    best_metric, sorted(metrics))
            metrics[best_metric] = worst
        return metrics or None

    def _fit_loop(self, state, it, eval_iter_fn, watchdog=None):
        cfg = self.config
        start_step = int(state.step)
        # steps_per_call > 1: self.train_step takes k stacked batches a
        # call (engine.make_multi_train_step) and every hook below fires
        # on a BOUNDARY CROSSING of its period, which at k = 1 is the
        # classic step % every == 0.  The last call is cut to the steps
        # left, so total_steps is exact; a hook reacts up to k steps late.
        k = max(1, cfg.steps_per_call)

        def crosses(lo, hi, every):  # does (lo, hi] hold a multiple?
            return bool(every) and hi // every > lo // every

        # the profile window is relative to THIS run's first step, so a
        # resumed run past profile_start still gets its trace
        profile_at = start_step + cfg.profile_start
        if cfg.profile_dir and self.capture is not None:
            self.capture.request(
                "static", steps=cfg.profile_steps, dir=cfg.profile_dir,
                at_step=profile_at, budget=False, cooldown=False,
                reason=f"--profile-dir window at step {profile_at}")
        try:
            step_i = start_step
            while step_i < cfg.total_steps:
                k_eff = min(k, cfg.total_steps - step_i)
                # the capture opens BEFORE the batch fetch so the profile
                # holds input-pipeline time too
                if self.capture is not None:
                    self.capture.maybe_start(step_i, k_eff)
                if self.tracer is not None:
                    self.tracer.begin_step(step_i + k_eff, k_eff)
                # data_wait is a plain-class span: StopIteration from
                # next(it) ends the fit and must escape unchanged
                with obs.span("data_wait"):
                    batch, k_eff = self._next_batch(it, k, k_eff)
                step = step_i + k_eff
                if self.tracer is not None:
                    # a short prebundled tail shrank the call
                    self.tracer.adjust_step(step, k_eff)
                with obs.span("train_step"):
                    state, metrics = self.train_step(state, batch)
                if k > 1:  # stacked (k_eff,) metrics: report the last
                    metrics = {name: v[-1] for name, v in metrics.items()}
                self.meter.update(k_eff)
                self._last_step = step
                if self.flight is not None:
                    # dispatch returned; the card may still be computing
                    self.flight.record("step", step=step, k=k_eff)
                for cb in self.callbacks:
                    cb.on_step_end(self, step, state, metrics)
                if watchdog is not None:
                    watchdog.ping()
                if self.capture is not None:
                    # the fetch makes the profiled steps end on the card
                    # before the trace closes
                    self.capture.maybe_stop(
                        step, fetch=lambda m=metrics: {
                            name: float(v) for name, v in m.items()})
                if cfg.log_every and (crosses(step_i, step, cfg.log_every)
                                      or step == cfg.total_steps):
                    self._log(step, metrics, state)
                if (self.eval_step is not None and eval_iter_fn is not None
                        and crosses(step_i, step, cfg.eval_every)):
                    with obs.span("eval"):
                        eval_metrics = self.evaluate(state, eval_iter_fn())
                    self._last_eval_metrics = eval_metrics
                    if self.flight is not None:
                        self.flight.record("eval", step=step)
                    self.writer.write(step, {f"eval_{name}": v for name, v
                                             in eval_metrics.items()})
                    logger.info("eval @ %d: %s", step, _fmt(eval_metrics))
                    for cb in self.callbacks:
                        cb.on_eval_end(self, step, state, eval_metrics)
                    if watchdog is not None:  # a long eval is progress
                        watchdog.ping()
                    if cfg.target_metric and self._target_reached(
                            eval_metrics, step):
                        return state
                if self.checkpointer is not None and crosses(
                        step_i, step, cfg.checkpoint_every):
                    # a call that crosses the period saves at the step it
                    # reached, which the manager's interval would skip
                    self.checkpointer.save(step, state,
                                           metrics=self._ckpt_metrics(),
                                           force=k > 1)
                    self._ckpt_count += 1
                    self._last_ckpt_step = step
                    for cb in self.callbacks:
                        cb.on_checkpoint(self, step, state)
                    if watchdog is not None:  # so is a synchronous save
                        watchdog.ping()
                # the preemption check comes LAST so a signal landing
                # mid-step is observed at the next boundary, the same on
                # every rank
                if self.preemption is not None and \
                        self.preemption.should_save(step):
                    logger.warning("preemption: consistent save at step %d, "
                                   "stopping", step)
                    self.preemption.save_and_exit(
                        step, state,
                        metrics=self._ckpt_metrics(self.preemption.manager))
                    self._preempted = True
                    return state
                if self.stop_training:
                    logger.info("callback requested stop at step %d", step)
                    return state
                if self.tracer is not None:
                    self.tracer.end_step()
                step_i = step
        finally:
            if self.capture is not None:
                # an exception mid-window or a window past total_steps:
                # close the trace and drop never-started requests
                self.capture.abort(self._last_step)
        if cfg.profile_dir and cfg.total_steps <= profile_at:
            logger.warning(
                "profile window never opened: run ended at step %d before "
                "profile_start step %d — lower --profile-start",
                cfg.total_steps, profile_at)
        return state

    def _next_batch(self, it, k: int, k_eff: int):
        """``(batch, k_eff)``: one batch at k = 1; else a bundle of
        ``k_eff`` steps, the iterator's own (``input_prebundled``: a
        longer one is cut, a shorter tail is TRAINED, shrinking the call)
        or ``k_eff`` batches stacked here.  An explicit loop, not a
        generator expression: an exhausted iterator must surface as
        StopIteration, not PEP 479's RuntimeError."""
        if k == 1:
            return next(it), 1
        if self.config.input_prebundled:
            bundle = next(it)
            have = next(iter(bundle.values())).shape[0]
            if have == 0:
                raise StopIteration
            if have > k_eff:
                bundle = {name: x[:k_eff] for name, x in bundle.items()}
            return bundle, min(have, k_eff)
        batches = []
        for _ in range(k_eff):
            batches.append(next(it))
        return {name: (np.stack([b[name] for b in batches])
                       if isinstance(batches[0][name], np.ndarray)
                       else torch.stack([b[name] for b in batches]))
                for name in batches[0]}, k_eff

    def _log(self, step: int, metrics: dict, state) -> None:
        """The log boundary: fetch the step's metrics (the one wait for
        the card), add throughput, memory, the span breakdown, the ranks'
        spread, the registry and the mode stamps; feed the anomaly
        detector; write the record, metrics.prom and goodput.json."""
        cfg = self.config
        with obs.span("host_block"):
            record = {k: float(v) for k, v in metrics.items()}
        record.update(self.meter.rates())
        mem_snap = obs.memory.collect()
        record.update(obs.memory.record_fields(mem_snap))
        if not self._state_bytes_fresh:
            self._refresh_state_bytes(state)  # the moments exist now
            self._state_bytes_fresh = True
        record.update(obs.memory.train_state_record_fields())
        # the live input-plane depths (adaptive prefetch, credit window)
        record.update(input_record_fields())
        obs.memory.update_registry(snapshot=mem_snap)
        breakdown = self._window_breakdown(step)
        record.update(breakdown)
        if bootstrap.process_count() > 1:
            # every rank reaches this branch, so the gather is consistent
            agg = obs.host_aggregate({
                "t_step": breakdown.get("t_step", 0.0),
                "t_data": breakdown.get("t_data", 0.0),
            })
            record.update(agg)
            summary = obs.straggler_summary(agg, "t_step")
            logger.info(summary)
            if self.capture is not None and cfg.auto_profile:
                # the ratio derives from the gathered fields, the same on
                # every rank, so all ranks arm (and open) consistently
                ratio = obs.spread_ratio(agg, "t_step")
                if ratio >= cfg.capture_spread_factor:
                    self.capture.request(
                        "straggler_spread",
                        reason=f"t_step spread {ratio:.1f}x median: "
                               f"{summary}")
        record.update(obs.default_registry().scalars())
        if cfg.quant and cfg.quant != "none":
            record["quant_mode"] = cfg.quant
        if cfg.overlap_buckets:
            record["overlap_buckets"] = float(cfg.overlap_buckets)
            record["overlap_coverage"] = float(cfg.overlap_coverage)
        if cfg.pipeline_stages:
            record["pipeline_schedule"] = cfg.pipeline_schedule
            record["pipeline_stages"] = float(cfg.pipeline_stages)
            record["pipeline_microbatches"] = float(cfg.pipeline_microbatches)
            record["pipeline_virtual"] = float(cfg.pipeline_virtual)
            record["pipeline_bubble"] = float(cfg.pipeline_bubble)
        if self.anomaly_detector is not None:
            self.anomaly_detector.observe(step, loss=record.get("loss"),
                                          step_time=breakdown.get("t_step"))
        self.writer.write(step, record)
        self._export_prometheus()
        ledger = obs.goodput.default_ledger()
        if ledger is not None:
            ledger.heartbeat(step=step)
        logger.info("step %d: %s", step, _fmt(record))
        self._last_record = record  # /statusz snapshot
        if self.flight is not None:
            self.flight.record("log", step=step, loss=record.get("loss"),
                               t_step=breakdown.get("t_step"))
        for cb in self.callbacks:
            cb.on_log(self, step, record)
        self.meter.start()

    def _window_breakdown(self, step_next: int) -> dict[str, float]:
        """Per-step time breakdown since the last log boundary: ``t_step``
        wall seconds a step; ``t_data`` / ``t_dispatch`` / ``t_host`` the
        data-wait, dispatch and metric-fetch span totals over the window's
        steps, ``f_*`` their fractions of ``t_step``; ``t_eval`` /
        ``t_ckpt`` when the window held eval/checkpoint work (those hooks
        run after the log write, so they land in the FOLLOWING window);
        the MFU fields when ``flops_per_step`` is set."""
        now = time.perf_counter()
        n = max(step_next - self._window_step0, 1)
        wall = max(now - self._window_t0, 1e-12)
        self._window_t0 = now
        self._window_step0 = step_next
        t_step = wall / n
        mfu = obs.mfu_record_fields(self.config.flops_per_step, t_step)
        if self.tracer is None:
            return {"t_step": t_step, **mfu}
        totals = self.tracer.drain_window()
        out = {
            "t_step": t_step,
            "t_data": totals.get("data_wait", 0.0) / n,
            "t_dispatch": totals.get("train_step", 0.0) / n,
            "t_host": totals.get("host_block", 0.0) / n,
        }
        if totals.get("eval"):
            out["t_eval"] = totals["eval"] / n
        if totals.get("checkpoint_save"):
            out["t_ckpt"] = totals["checkpoint_save"] / n
        for part in ("data", "dispatch", "host"):
            out[f"f_{part}"] = out[f"t_{part}"] / t_step
        out.update(mfu)
        return out

    def status(self) -> dict:
        """/statusz payload: run position, last logged metrics, breakdown,
        rank spread, checkpoint state.  Reads plain attributes only —
        never syncs the device, so it answers mid-hang."""
        rec = self._last_record
        out: dict = {
            "run": {
                "step": self._last_step,
                "total_steps": self.config.total_steps,
                "fit_elapsed_s": (round(time.time() - self._fit_t0, 1)
                                  if self._fit_t0 else None),
                "preempted": self._preempted,
                "stop_requested": self.stop_training,
            },
        }
        cfg = self.config
        if cfg.zero_stage:
            out["run"]["zero_stage"] = cfg.zero_stage
        if cfg.quant and cfg.quant != "none":
            out["run"]["quant"] = cfg.quant
        if cfg.overlap_buckets:
            out["run"]["overlap_buckets"] = cfg.overlap_buckets
        if cfg.dynamics_every:
            out["run"]["dynamics_every"] = cfg.dynamics_every
        if cfg.pipeline_stages:
            out["run"]["pipeline"] = {
                "schedule": cfg.pipeline_schedule,
                "stages": cfg.pipeline_stages,
                "microbatches": cfg.pipeline_microbatches,
                "virtual": cfg.pipeline_virtual,
                "bubble": round(cfg.pipeline_bubble, 4),
            }
        core = {k: rec[k] for k in (
            "loss", "accuracy", "steps_per_sec", "examples_per_sec_per_chip",
            "mfu", "hbm_in_use_gib", "hbm_peak_gib", "host_rss_gib",
            "live_arrays_gib") if k in rec}
        if core:
            out["last_log"] = core
        breakdown = {k: rec[k] for k in (
            "t_step", "t_data", "t_dispatch", "t_host", "t_eval", "t_ckpt",
            "f_data", "f_dispatch", "f_host") if k in rec}
        if breakdown:
            out["breakdown"] = breakdown
        spread = {k: v for k, v in rec.items()
                  if "_host_" in k or k.endswith("_straggler")}
        if spread:
            out["host_spread"] = spread
        if self.anomaly_detector is not None:
            out["anomalies"] = len(self.anomaly_detector.anomalies)
        wd = self.watchdog  # snapshot: the fit's finally nulls it
        if wd is not None:
            out["watchdog"] = {"ping_age_s": round(wd.ping_age(), 1),
                               "timeout_s": wd.timeout, "fired": wd.fired}
        if self.checkpointer is not None:
            out["checkpoint"] = {"saves": self._ckpt_count,
                                 "last_saved_step": self._last_ckpt_step}
        if self.supervisor_status:
            out["supervisor"] = dict(self.supervisor_status)
        if self.capture is not None:
            cap_state = self.capture.state()
            out["captures"] = {
                "completed": len(cap_state["captures"]),
                "budget": f"{cap_state['used']}/{cap_state['max_captures']}",
                "active": cap_state["active"] is not None,
                "armed": (cap_state["armed"] is not None
                          or cap_state["scheduled"] is not None),
            }
        if self._last_eval_metrics:
            out["last_eval"] = dict(self._last_eval_metrics)
        return out

    def health(self) -> dict:
        """/healthz payload; ``ok`` False (HTTP 503) once the watchdog has
        fired."""
        out: dict = {"ok": True, "last_step": self._last_step}
        wd = self.watchdog  # snapshot: the fit's finally nulls it
        if wd is not None:
            out["watchdog_ping_age_s"] = round(wd.ping_age(), 1)
            out["watchdog_timeout_s"] = wd.timeout
            out["ok"] = not wd.fired
        return out

    def _export_prometheus(self) -> None:
        if self.config.logdir is None or bootstrap.process_index() != 0:
            return
        try:
            obs.default_registry().write_prometheus(
                os.path.join(self.config.logdir, "metrics.prom"))
        except OSError:  # a full/readonly disk must not kill the fit
            logger.exception("prometheus snapshot write failed")

    def _target_reached(self, eval_metrics: dict, step: int) -> bool:
        cfg = self.config
        if cfg.target_metric not in eval_metrics:
            logger.warning(
                "target metric %r not in eval metrics %s; gate cannot fire",
                cfg.target_metric, sorted(eval_metrics))
            return False
        value = eval_metrics[cfg.target_metric]
        hit = (value <= cfg.target_value if cfg.target_mode == "min"
               else value >= cfg.target_value)
        if hit:
            logger.info(
                "target reached: %s=%.4f %s %.4f at step %d; stopping",
                cfg.target_metric, value,
                "<=" if cfg.target_mode == "min" else ">=",
                cfg.target_value, step)
        return hit

    def evaluate(self, state: TrainState, eval_iter: Iterable[dict]) -> dict:
        """Eval metrics averaged with each batch weighted by its rows;
        ``eval_steps <= 0`` consumes the whole iterator."""
        return weighted_evaluate(self.eval_step, state, eval_iter,
                                 max_steps=self.config.eval_steps)


def device_memory_stats() -> dict[str, float]:
    """The first local device's allocator memory in use and peak (GiB),
    the cheap read without the rest of ``obs.memory.record_fields``;
    nothing without a CUDA device."""
    devices = obs.memory.device_memory_snapshot()
    if not devices:
        return {}
    gib = 1 / (1024 ** 3)
    return {"hbm_in_use_gib": devices[0]["bytes_in_use"] * gib,
            "hbm_peak_gib": devices[0]["peak_bytes_in_use"] * gib}


def weighted_evaluate(
    eval_step: Callable[[TrainState, dict], dict],
    state: TrainState,
    eval_iter: Iterable[dict],
    *,
    max_steps: int = 0,
) -> dict:
    """Batch-size-weighted metric averaging: metrics are per-example
    means, so weighting each batch by its rows makes a ragged final batch
    count once per example.  ``max_steps <= 0`` consumes the whole
    iterator."""
    sums: dict[str, float] = {}
    total_w = 0.0
    try:
        for i, batch in enumerate(eval_iter):
            if max_steps > 0 and i >= max_steps:
                break
            w = float(next(iter(batch.values())).shape[0])
            metrics = eval_step(state, batch)
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + w * float(v)
            total_w += w
    finally:
        close = getattr(eval_iter, "close", None)
        if close is not None:
            close()
    return {k: v / max(total_w, 1.0) for k, v in sums.items()}


def _fmt(metrics: dict[str, Any]) -> str:
    return " ".join(
        f"{k}={v}" if isinstance(v, str) else f"{k}={v:.4g}"
        for k, v in metrics.items())
