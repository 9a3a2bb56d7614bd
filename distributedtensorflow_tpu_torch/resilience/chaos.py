"""Deterministic fault injection: make the recovery stack testable.

Twin of ``distributedtensorflow_tpu/resilience/chaos.py``: the same fault
plans (``train_torch.py --fault-plan``, the same JSON schema, validation
and messages), the same ``faults.jsonl`` rows byte for byte (so
``tools/check_metrics_schema.py`` and ``tools/run_report.py`` read them
unchanged), the same counters ``faults_injected_total`` and
``faults_recovered_total`` (in the port's registry) and flight events.
A plan::

    {"faults": [
      {"step": 35,  "kind": "worker_kill"},
      {"step": 45,  "kind": "checkpoint_truncate"},
      {"step": 70,  "kind": "nan_loss"},
      {"step": 100, "kind": "data_stall", "stall_s": 0.1},
      {"step": 110, "kind": "preemption"}
    ]}

(a bare JSON list of fault objects is accepted too).  Fault kinds:

``nan_loss``
    The wrapped train step reports a NaN loss at the trigger step; the
    AnomalyDetector flags it at the next log boundary and the
    Supervisor's watch turns it into a restart from a checkpoint *before*
    the poisoned step.  ``"module": "h1"`` also fills that top-level
    module's parameters with NaN (the NaN-provenance drill).
``checkpoint_truncate``
    The first checkpoint save at or after the trigger step is truncated
    on disk after its commit, so the next ``restore_latest`` rejects it
    and falls back to an older verified step.
``worker_kill``
    SIGKILLs an attached process-backed coordinator worker, then raises
    :class:`WorkerKilledFault` out of the fit.
``data_stall``
    Blocks the fit loop ``stall_s`` seconds, then raises
    :class:`DataStallFault`.
``preemption``
    ``PreemptionHandler.trigger()``: the trainer's consistent-save path
    runs and the fit exits preempted; the supervisor resumes it.
``resize``
    Requests an elastic resize through an attached controller
    (:meth:`ChaosInjector.attach_elastic`); the port attaches none yet,
    so the fault logs that and stays unrecovered (the run exits 4), as
    the reference does without ``--elastic``.
``net_delay``, ``net_drop``, ``net_sever``, ``dispatcher_kill``
    Injected at the ``net`` layer and recovered by the transport (their
    ``recovered`` row is written at the first successful matching call).

What differs from JAX:

- The step is the port's ``step(state, batch) -> (state, metrics)``.
  The NaN goes into the *returned* metrics (``torch.full_like``); at
  ``steps_per_call`` > 1 those are a copy of the CUDA graph's table, so
  the graph's own buffers never see it.  A ``module`` poison fills that
  module's parameters with NaN in place; the module is named by the flax
  top-level names, resolved through ``models.flax_modules``
  (:meth:`ChaosInjector.wrap_train_step`'s ``modules``), so one plan
  file names the same module in both packages.
- The checkpoint manager's save returns before its writer thread
  commits: the truncation waits for the commit (``manager.wait()``),
  then halves the step directory's largest file (``state.pt``), which
  the manager's CRC32 manifest check rejects.  Over ranks only the
  writing rank (the chief) tears the file; every rank records the fault.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Any

from .. import obs
from ..train.trainer import Callback

logger = logging.getLogger(__name__)

__all__ = [
    "FAULT_KINDS",
    "NET_FAULT_KINDS",
    "ChaosInjector",
    "DataStallFault",
    "FaultPlan",
    "InjectedFault",
    "WorkerKilledFault",
]

#: Fault kinds recovered by the resilient transport itself (no restart):
#: the supervisor's mark_recovered must NOT claim these — their recovery
#: row is written when the net layer observes a post-fault success.
NET_FAULT_KINDS = (
    "net_delay",
    "net_drop",
    "net_sever",
    "dispatcher_kill",
)

#: The known fault kinds (duplicated stdlib-side in
#: tools/check_metrics_schema.py FAULT_KINDS — keep in sync).
FAULT_KINDS = (
    "nan_loss",
    "checkpoint_truncate",
    "worker_kill",
    "data_stall",
    "preemption",
    "resize",
) + NET_FAULT_KINDS

_M_INJECTED = obs.counter(
    "faults_injected_total", "chaos faults injected, by kind"
)
_M_RECOVERED = obs.counter(
    "faults_recovered_total", "chaos faults recovered from, by kind"
)


class InjectedFault(RuntimeError):
    """Base of chaos-raised failures; ``kind`` drives the supervisor's
    classification and ``fault_id`` pairs the recovery row."""

    kind = "injected"

    def __init__(self, message: str, *, fault_id: int, step: int):
        super().__init__(message)
        self.fault_id = fault_id
        self.step = step


class WorkerKilledFault(InjectedFault):
    kind = "worker_kill"


class DataStallFault(InjectedFault):
    kind = "data_stall"


@dataclasses.dataclass
class _Fault:
    id: int
    step: int
    kind: str
    params: dict
    injected: bool = False
    recovered: bool = False
    #: The step the injection actually fired at (>= the plan's trigger
    #: step); recovery rows echo it so a pair shares one step.
    injected_step: int | None = None
    #: checkpoint_truncate: the step of the save actually truncated.
    detail_step: int | None = None


class FaultPlan:
    """A validated, step-sorted list of fault triggers."""

    def __init__(self, faults: list[dict]):
        parsed: list[_Fault] = []
        for i, f in enumerate(faults):
            if not isinstance(f, dict):
                raise ValueError(f"fault[{i}]: not an object: {f!r}")
            kind = f.get("kind")
            if kind not in FAULT_KINDS:
                raise ValueError(
                    f"fault[{i}]: unknown kind {kind!r} "
                    f"(known: {', '.join(FAULT_KINDS)})"
                )
            step = f.get("step")
            if not isinstance(step, int) or isinstance(step, bool) \
                    or step < 0:
                raise ValueError(
                    f"fault[{i}]: step {step!r} is not a non-negative int"
                )
            params = {k: v for k, v in f.items() if k not in ("kind", "step")}
            parsed.append(_Fault(id=i, step=int(step), kind=kind,
                                 params=params))
        parsed.sort(key=lambda f: (f.step, f.id))
        # Re-id in trigger order so injected ids are strictly increasing.
        for i, f in enumerate(parsed):
            f.id = i
        self.faults = parsed

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            doc = json.load(f)
        if isinstance(doc, dict):
            doc = doc.get("faults")
        if not isinstance(doc, list):
            raise ValueError(
                f"{path}: expected a JSON list of faults or an object "
                "with a 'faults' list"
            )
        return cls(doc)

    def __len__(self) -> int:
        return len(self.faults)


class ChaosInjector(Callback):
    """Executes a :class:`FaultPlan` against a run and logs
    ``faults.jsonl``.

    Wiring (train_torch.py does all of this under ``--fault-plan``):

    - append the injector itself to the Trainer's callbacks (it is a
      :class:`~..train.trainer.Callback`; ``on_step_end`` fires the
      worker-kill / data-stall / preemption triggers);
    - ``train_step = injector.wrap_train_step(train_step, modules)`` for
      NaN injection (it reads ``state.step``, a host int here);
    - ``checkpointer = injector.wrap_checkpointer(checkpointer)`` for
      post-commit truncation;
    - :meth:`attach_preemption` / :meth:`attach_coordinator` for the
      signal-shaped faults.

    The Supervisor closes the loop: :meth:`mark_recovered` after each
    successful restart writes the paired ``recovered`` rows.
    """

    def __init__(self, plan: FaultPlan, logdir: str | None = None):
        self.plan = plan
        self._lock = threading.Lock()
        self._path = (
            os.path.join(logdir, "faults.jsonl") if logdir else None
        )
        self._preemption = None
        self._coordinator = None
        self._dispatcher = None
        self._dispatcher_restart = None
        self._elastic = None
        self._mid_resize_kill: _Fault | None = None
        if self._path:
            os.makedirs(logdir, exist_ok=True)
            # Truncate a prior run's log: the plan restarts from scratch.
            open(self._path, "w").close()

    # -- wiring --------------------------------------------------------------

    def attach_preemption(self, handler) -> None:
        """The PreemptionHandler ``preemption`` faults trigger()."""
        self._preemption = handler

    def attach_coordinator(self, coord) -> None:
        """A process-backed Coordinator whose worker 0 ``worker_kill``
        faults SIGKILL (optional — without one the fault only raises)."""
        self._coordinator = coord

    def attach_elastic(self, controller) -> None:
        """The :class:`~.elastic.ElasticController` that ``resize``
        faults drive; its completion callback writes the paired
        ``recovered`` row whatever the window's outcome."""
        self._elastic = controller

    def attach_data_service(self, dispatcher, restart_fn) -> None:
        """The data-service control plane ``dispatcher_kill`` faults
        target: ``dispatcher`` is the live ``DispatchServer``,
        ``restart_fn()`` builds its replacement on the SAME port from
        the durable journal.  Also gives :meth:`on_fit_end` a live
        endpoint to probe when pairing net-fault recovery rows."""
        self._dispatcher = dispatcher
        self._dispatcher_restart = restart_fn

    def wrap_train_step(self, train_step, modules: dict | None = None):
        """NaN-loss injection: at the trigger step the returned metrics
        report a NaN loss (``torch.full_like`` of the step's loss: a
        (k,) copy at ``steps_per_call`` k > 1, never the graph's own
        table).  Without a ``module`` param the state is untouched; with
        ``{"module": "h1"}`` the parameters whose top-level flax module
        is ``h1`` (``modules``: port parameter name -> that name,
        ``models.flax_modules``) are ALSO filled with NaN in place, the
        provenance-accuracy drill."""
        import torch  # noqa: PLC0415

        def _poison_module(state, module: str) -> bool:
            names = {n for n, m in (modules or {}).items() if m == module}
            params = [p for n, p in state.model.named_parameters()
                      if n in names]
            if not params:
                logger.error(
                    "chaos: nan_loss module %r not a top-level param "
                    "module (have: %s) — loss-only injection",
                    module, sorted(set((modules or {}).values())))
                return False
            with torch.no_grad():
                for p in params:
                    p.fill_(float("nan"))
            return True

        def chaotic_step(state, batch):
            step_before = int(state.step)
            new_state, metrics = train_step(state, batch)
            fault = self._pending("nan_loss", step_before + 1)
            if fault is not None and "loss" in metrics:
                module = fault.params.get("module")
                extra = {}
                if module and _poison_module(new_state, str(module)):
                    extra["module"] = str(module)
                self._inject(fault, at_step=step_before + 1, **extra)
                metrics = dict(
                    metrics,
                    loss=torch.full_like(metrics["loss"], float("nan")),
                )
            return new_state, metrics

        return chaotic_step

    def wrap_checkpointer(self, manager):
        """Proxy whose ``save`` truncates the on-disk checkpoint when a
        ``checkpoint_truncate`` fault has come due."""
        return _ChaosCheckpointer(manager, self)

    # -- Callback hooks (worker_kill / data_stall / preemption) --------------

    #: Kinds fired from on_step_end (nan_loss fires inside the wrapped
    #: train step, checkpoint_truncate inside the wrapped save).
    _STEP_KINDS = ("preemption", "data_stall", "worker_kill", "resize") \
        + NET_FAULT_KINDS

    def on_step_end(self, trainer, step: int, state, metrics) -> None:
        # Due faults fire in id (= plan trigger) order, so injected rows
        # keep their strictly-increasing-id invariant even when a
        # transport fault and a process fault share a trigger step; a
        # raising kind naturally ends the batch (the rest re-trigger
        # after the supervised restart re-reaches this step).
        while True:
            with self._lock:
                due = [
                    f for f in self.plan.faults
                    if not f.injected and f.step <= step
                    and f.kind in self._STEP_KINDS
                ]
            if not due:
                return
            self._fire_one(min(due, key=lambda f: f.id), step)

    def _fire_one(self, fault: _Fault, step: int) -> None:
        kind = fault.kind
        if kind in NET_FAULT_KINDS:
            self._fire_net_fault(fault, step)
            return
        if kind == "preemption":
            self._inject(fault, at_step=step)
            if self._preemption is not None:
                self._preemption.trigger()
            else:
                logger.error(
                    "chaos: preemption fault at step %d but no handler "
                    "attached; fault is a no-op", step,
                )
            return
        if kind == "data_stall":
            stall_s = float(fault.params.get("stall_s", 0.0))
            self._inject(fault, at_step=step, stall_s=stall_s)
            if stall_s > 0:
                # The fit loop stops making progress right here — a long
                # enough stall fires the hang watchdog mid-sleep.
                time.sleep(stall_s)
            raise DataStallFault(
                f"chaos: input pipeline stalled at step {step}",
                fault_id=fault.id, step=step,
            )
        if kind == "resize":
            devices = int(fault.params.get("devices", 0))
            compose = fault.params.get("compose")
            extra = {"devices": devices}
            if compose:
                extra["compose"] = str(compose)
            self._inject(fault, at_step=step, **extra)
            if self._elastic is None:
                logger.error(
                    "chaos: resize fault at step %d but no elastic "
                    "controller attached; fault cannot recover", step,
                )
                return
            if compose == "worker_kill":
                with self._lock:
                    self._mid_resize_kill = fault
            ok, msg = self._elastic.request_resize(
                devices, source="chaos",
                on_done=lambda outcome, info, f=fault:
                    self._resize_done(f, outcome, info),
            )
            if not ok:
                logger.error("chaos: resize fault #%d rejected: %s",
                             fault.id, msg)
                with self._lock:
                    if self._mid_resize_kill is fault:
                        self._mid_resize_kill = None
                self._resize_done(fault, "rejected", {})
            return
        if kind == "worker_kill":
            self._inject(fault, at_step=step)
            if self._coordinator is not None:
                try:
                    self._coordinator.kill_worker_process(
                        int(fault.params.get("worker", 0))
                    )
                except Exception:
                    logger.exception("chaos: coordinator worker kill failed")
            raise WorkerKilledFault(
                f"chaos: worker killed at step {step}",
                fault_id=fault.id, step=step,
            )

    # -- elastic resize faults (controller-recovered) ------------------------

    def mid_resize_fault(self) -> None:
        """Hook for the entrypoint's resize_fn, called between the drain
        save and the mesh commit: raises the armed composed
        ``worker_kill`` (a ``resize`` fault with ``"compose":
        "worker_kill"``), simulating a crash landing mid-resize.  A no-op
        when nothing is armed."""
        with self._lock:
            fault, self._mid_resize_kill = self._mid_resize_kill, None
        if fault is None:
            return
        step = (fault.injected_step if fault.injected_step is not None
                else fault.step)
        raise WorkerKilledFault(
            f"chaos: worker killed mid-resize (fault #{fault.id})",
            fault_id=fault.id, step=step,
        )

    def _resize_done(self, fault: _Fault, outcome: str, info: dict) -> None:
        """Completion callback from the ElasticController: write the
        paired ``recovered`` row (idempotent).  Every outcome pairs the
        row — a ``failed`` resize recovered by falling back to the
        pre-resize checkpoint, a ``rejected`` one by never starting."""
        with self._lock:
            if not fault.injected or fault.recovered:
                return
            fault.recovered = True
            _M_RECOVERED.inc(kind=fault.kind)
            step = (fault.injected_step if fault.injected_step is not None
                    else fault.step)
            resumed = info.get("resumed_step")
            self._write({
                "t": time.time(), "id": fault.id, "step": step,
                "kind": fault.kind, "phase": "recovered",
                "resumed_step": int(resumed if resumed is not None
                                    else step),
                "attempt": int(info.get("attempt", 0)),
                "outcome": str(outcome),
            })
        logger.warning("chaos: resize fault #%d finished (%s)",
                       fault.id, outcome)

    # -- network faults (transport-recovered) --------------------------------

    def _fire_net_fault(self, fault: _Fault, step: int) -> None:
        """Arm/execute one due ``net_*`` / ``dispatcher_kill`` fault.
        None of these raise: the resilient transport is what is under
        test, and the run must proceed THROUGH the fault."""
        from ..net import rpc as netrpc  # noqa: PLC0415

        if fault.kind == "net_delay":
            self._inject(fault, at_step=step)
            netrpc.arm_fault(
                "net_delay",
                calls=int(fault.params.get("calls", 4)),
                delay_s=float(fault.params.get("delay_s", 0.05)),
                match=str(fault.params.get("endpoint", "")),
                on_recovered=lambda f=fault: self._recover_net(f),
            )
        elif fault.kind == "net_drop":
            self._inject(fault, at_step=step)
            netrpc.arm_fault(
                "net_drop",
                calls=int(fault.params.get("calls", 2)),
                match=str(fault.params.get("endpoint", "")),
                on_recovered=lambda f=fault: self._recover_net(f),
            )
        elif fault.kind == "net_sever":
            n = netrpc.sever_streams(str(fault.params.get("endpoint", "")))
            self._inject(fault, at_step=step, severed=n)
            # Recovery = the next successful matching attempt (the
            # severed streams' reconnect, or — when nothing was live to
            # sever — any healthy call proving the plane still works).
            netrpc.watch_recovery(
                str(fault.params.get("endpoint", "")),
                on_recovered=lambda f=fault: self._recover_net(f),
            )
        elif fault.kind == "dispatcher_kill":
            self._inject(fault, at_step=step)
            self._dispatcher_kill(fault, step)

    def _recover_net(self, fault: _Fault, *, resumed_step: int | None = None,
                     attempt: int = 0) -> None:
        """Write the paired ``recovered`` row for a transport-absorbed
        fault (idempotent; callable from any thread — the net layer fires
        it from whichever thread observed the post-fault success)."""
        with self._lock:
            if not fault.injected or fault.recovered:
                return
            fault.recovered = True
            _M_RECOVERED.inc(kind=fault.kind)
            step = (fault.injected_step if fault.injected_step is not None
                    else fault.step)
            self._write({
                "t": time.time(), "id": fault.id, "step": step,
                "kind": fault.kind, "phase": "recovered",
                "resumed_step": int(resumed_step if resumed_step is not None
                                    else step),
                "attempt": int(attempt),
            })
        logger.warning("chaos: transport recovered from %s (fault #%d)",
                       fault.kind, fault.id)

    def _dispatcher_kill(self, fault: _Fault, step: int) -> None:
        """Kill → breaker-open → journal-replay restart → probe-closed.

        Runs synchronously on the trainer thread (chaos is a test
        harness): the data streams to the WORKERS keep flowing the whole
        time — only the control plane dies — and the dispatcher endpoint
        breaker is driven through a full open → half_open → closed cycle
        so the recovery is visible in ``breaker_transitions_total``."""
        from ..net import breaker as netbreaker  # noqa: PLC0415
        from ..net import rpc as netrpc  # noqa: PLC0415

        if self._dispatcher is None or self._dispatcher_restart is None:
            logger.error(
                "chaos: dispatcher_kill at step %d but no data service "
                "attached; fault cannot recover", step,
            )
            return
        target = self._dispatcher.target()
        ep = f"dispatcher:{target}"
        probe = netrpc.RetryPolicy(deadline_s=0.5, max_attempts=1,
                                   connect_timeout_s=0.3)
        self._dispatcher.kill()
        logger.warning("chaos: dispatcher %s killed at step %d", target,
                       step)
        # Fail fast probes until the endpoint breaker trips open.
        br = netbreaker.breaker_for(ep)
        deadline = time.monotonic() + 15.0
        while br.state != "open" and time.monotonic() < deadline:
            try:
                netrpc.call(target, {"kind": "get_workers"}, endpoint=ep,
                            policy=probe)
            except OSError:
                pass
        # Restart on the same port from the journal (the port may sit in
        # TIME_WAIT for a beat — retry the bind briefly).
        restarted = None
        deadline = time.monotonic() + 15.0
        while restarted is None and time.monotonic() < deadline:
            try:
                restarted = self._dispatcher_restart()
            except OSError:
                time.sleep(0.2)
        if restarted is None:
            logger.error("chaos: dispatcher restart failed; fault #%d "
                         "stays unrecovered", fault.id)
            return
        self._dispatcher = restarted
        # Probe until the breaker's half-open probe closes it again.
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            try:
                resp, _ = netrpc.call(target, {"kind": "get_workers"},
                                      endpoint=ep, policy=probe)
            except OSError:
                time.sleep(0.2)
                continue
            if resp.get("ok"):
                self._recover_net(fault, resumed_step=step)
                logger.warning(
                    "chaos: dispatcher %s restarted from journal "
                    "(breaker %s)", target, br.state,
                )
                return
        logger.error("chaos: restarted dispatcher %s never answered; "
                     "fault #%d stays unrecovered", target, fault.id)

    def on_fit_end(self, trainer, state) -> None:
        """Pair any armed-but-unproven net faults before the run ends: a
        successful probe against the attached dispatcher counts as the
        post-fault success for every matching fault still watching."""
        from ..net import rpc as netrpc  # noqa: PLC0415

        pending = [
            f for f in self.plan.faults
            if f.kind in NET_FAULT_KINDS and f.injected and not f.recovered
        ]
        if not pending or self._dispatcher is None:
            return
        target = self._dispatcher.target()
        probe = netrpc.RetryPolicy(deadline_s=1.0, max_attempts=1)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            try:
                netrpc.call(target, {"kind": "get_workers"},
                            endpoint=f"dispatcher:{target}", policy=probe)
            except OSError:
                time.sleep(0.2)
                continue
            if all(f.recovered for f in pending):
                return
            time.sleep(0.1)

    # -- recovery bookkeeping (called by the Supervisor) ---------------------

    def mark_recovered(self, *, resumed_step: int, attempt: int,
                       rejected_steps: list[int] | None = None) -> int:
        """Write ``recovered`` rows for every injected-but-unrecovered
        fault this restart resolves: the restart-shaped kinds always; a
        ``checkpoint_truncate`` only once a fallback restore actually
        rejected its truncated step (``rejected_steps``).  Returns the
        number of rows written."""
        rejected = set(rejected_steps or ())
        n = 0
        with self._lock:
            for f in self.plan.faults:
                if not f.injected or f.recovered:
                    continue
                if f.kind in NET_FAULT_KINDS:
                    # Transport-recovered, not restart-recovered: their
                    # row is written when the net layer proves a
                    # post-fault success (_recover_net).
                    continue
                if f.kind == "resize":
                    # Controller-recovered: the ElasticController's
                    # completion callback writes the row (_resize_done)
                    # whatever the window's outcome.
                    continue
                if f.kind == "checkpoint_truncate":
                    if f.detail_step not in rejected:
                        continue
                f.recovered = True
                n += 1
                _M_RECOVERED.inc(kind=f.kind)
                self._write({
                    "t": time.time(), "id": f.id,
                    "step": (f.injected_step if f.injected_step is not None
                             else f.step),
                    "kind": f.kind, "phase": "recovered",
                    "resumed_step": int(resumed_step),
                    "attempt": int(attempt),
                })
        return n

    def unrecovered(self) -> list[dict]:
        """Injected faults still awaiting a recovery row (a non-empty
        answer at run end = the run did not actually self-heal)."""
        with self._lock:
            return [
                {"id": f.id, "step": f.step, "kind": f.kind}
                for f in self.plan.faults
                if f.injected and not f.recovered
            ]

    # -- internals -----------------------------------------------------------

    def _pending(self, kind: str, step: int) -> _Fault | None:
        """The first uninjected fault of ``kind`` whose trigger step has
        come (<= step), or None."""
        with self._lock:
            for f in self.plan.faults:
                if f.kind == kind and not f.injected and f.step <= step:
                    return f
        return None

    def _inject(self, fault: _Fault, *, at_step: int, **fields) -> None:
        with self._lock:
            if fault.injected:
                return
            fault.injected = True
            fault.injected_step = int(at_step)
            _M_INJECTED.inc(kind=fault.kind)
            row = {
                "t": time.time(), "id": fault.id, "step": int(at_step),
                "kind": fault.kind, "phase": "injected",
            }
            row.update(fields)
            self._write(row)
        logger.warning(
            "chaos: injected %s (fault #%d) at step %d",
            fault.kind, fault.id, at_step,
        )
        obs.record_event(
            "fault", step=int(at_step), fault=fault.kind, phase="injected",
            id=fault.id,
        )

    def _note_truncated(self, fault: _Fault, save_step: int) -> None:
        with self._lock:
            fault.detail_step = int(save_step)

    def _write(self, row: dict[str, Any]) -> None:
        """Append one faults.jsonl line (caller holds the lock); a write
        failure must never escalate an injected fault into a crash."""
        if self._path is None:
            return
        try:
            with open(self._path, "a") as f:
                f.write(json.dumps(row) + "\n")
        except OSError:
            logger.exception("chaos: faults.jsonl append failed")


class _ChaosCheckpointer:
    """CheckpointManager proxy that truncates the bytes of a just-saved
    step when a ``checkpoint_truncate`` fault is due — the torn-write
    storage fault, injected at the exact layer it happens in production."""

    def __init__(self, manager, injector: ChaosInjector):
        self._manager = manager
        self._injector = injector

    def save(self, step: int, state, **kwargs) -> bool:
        saved = self._manager.save(step, state, **kwargs)
        if saved:
            fault = self._injector._pending("checkpoint_truncate", step)
            if fault is not None:
                # the save returned with its writer thread running: the
                # bytes must be committed on disk to tear
                self._manager.wait()
                self._injector._inject(fault, at_step=step,
                                       truncated_step=step)
                self._injector._note_truncated(fault, step)
                chief = getattr(self._manager, "_is_chief", None)
                if chief is None or chief():
                    self._truncate(step)
        return saved

    def _truncate(self, step: int) -> None:
        directory = getattr(self._manager, "_directory", None)
        if directory is None:
            return
        step_dir = os.path.join(directory, str(int(step)))
        biggest, size = None, -1
        for root, _dirs, files in os.walk(step_dir):
            for name in files:
                p = os.path.join(root, name)
                s = os.path.getsize(p)
                if s > size:
                    biggest, size = p, s
        if biggest is None:
            logger.error("chaos: no files to truncate under %s", step_dir)
            return
        with open(biggest, "r+b") as f:
            f.truncate(max(size // 2, 1))
        logger.warning(
            "chaos: truncated %s (%d -> %d bytes)", biggest, size,
            max(size // 2, 1),
        )

    def __getattr__(self, name):
        return getattr(self._manager, name)
