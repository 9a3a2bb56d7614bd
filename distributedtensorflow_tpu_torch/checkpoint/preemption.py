"""Preemption-aware checkpointing.

Twin of ``distributedtensorflow_tpu/checkpoint/preemption.py``
(``:41-185``).  The preemption notice (SIGTERM on GCE and Borg) is caught
per process and only sets a flag.  At a step boundary
:meth:`PreemptionHandler.should_save` turns the flags of every rank into
one answer, the same on all of them, and :meth:`save_and_exit` forces a
save of that step and waits for its commit; the launcher's restart
resumes from it.  Telemetry (``obs``), as in JAX: the counter
``preemptions_total``, the flight events ``preemption`` and
``preemption_save``, the recorder's dump once the save is committed, and
the goodput generation closed as ``preempted``.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Callable

from .. import obs
from ..parallel import collectives
from .manager import CheckpointManager, group_max

logger = logging.getLogger(__name__)

# Registry metric: preemption notices observed by this process; the
# flight recorder gets the per-event record (signal number, save step).
_M_PREEMPTIONS = obs.counter(
    "preemptions_total", "preemption notices observed (signal or trigger)"
)


class PreemptionHandler:
    """Watches for a preemption signal; coordinates a consistent save.

    Usage::

        handler = PreemptionHandler(manager)
        for step in range(n):
            state, metrics = train_step(state, batch)
            if handler.should_save(state.step):
                handler.save_and_exit(state.step, state)
                break
    """

    def __init__(
        self,
        manager: CheckpointManager,
        *,
        signals: tuple[int, ...] = (signal.SIGTERM,),
        mesh=None,
        on_exit: Callable[[], None] | None = None,
        poll_every: int = 10,
    ):
        """``mesh``: the mesh or process group whose ranks agree on the
        save (default: the default group when ``torch.distributed`` is
        initialised, else this process alone)."""
        self._manager = manager
        self._mesh = mesh
        self._on_exit = on_exit
        self._poll_every = max(1, poll_every)
        self._flag = threading.Event()
        #: Signal-context stash: (source, signum) awaiting a lock-safe
        #: flush; ``_recorded`` dedupes repeated notices.
        self._pending: tuple[str, int] | None = None
        self._recorded = False
        self._installed = []
        for sig in signals:
            try:
                prev = signal.signal(sig, self._on_signal)
                self._installed.append((sig, prev))
            except ValueError:  # not on the main thread (tests)
                pass

    def _on_signal(self, signum, frame):
        # a signal handler interrupts the main thread wherever it is, maybe
        # inside the flight ring's or a counter's lock (the fit loop records
        # a flight event every step): stash the notice, set the flag, and
        # record and act at the next step boundary
        logger.warning("preemption signal %s received", signum)
        if not self._flag.is_set():
            self._pending = ("signal", int(signum))
        self._flag.set()

    def _record_preemption(self, *, source: str, signum: int | None = None):
        """The ``preemption`` flight event and ``preemptions_total``, once
        a preemption."""
        if self._recorded:
            return
        self._recorded = True
        _M_PREEMPTIONS.inc()
        event = {"source": source}
        if signum is not None:
            event["signal"] = signum
        obs.record_event("preemption", **event)

    def _flush_pending(self) -> None:
        pending, self._pending = self._pending, None
        if pending is not None:
            self._record_preemption(source=pending[0], signum=pending[1])

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()

    @property
    def manager(self) -> CheckpointManager:
        """The manager preemption saves go through."""
        return self._manager

    def trigger(self) -> None:
        """Programmatic preemption (tests, external watchers)."""
        self._record_preemption(source="trigger")
        self._flag.set()

    def should_save(self, step: int | None = None) -> bool:
        """Whether to save and stop at this step boundary (call it every
        step).  One process: the local flag.  Over a group of ranks: the
        flag of any rank, found by one MAX all-reduce of an int, on every
        ``poll_every``-th step only.  Every rank must enter the collective
        at the same steps, so the schedule is a pure function of ``step``;
        a flag set in between waits for the next poll step.  ``step=None``
        polls now."""
        self._flush_pending()
        local = 1 if self._flag.is_set() else 0
        if collectives.group_size(self._mesh) == 1:
            return bool(local)
        if step is not None and step % self._poll_every:
            return False
        return group_max(local, self._mesh) > 0

    def save_and_exit(self, step: int, state, metrics: dict | None = None
                      ) -> None:
        """Force-save ``step`` now, wait for its commit, then run the exit
        hook (default: nothing; the caller stops, and the launcher's
        restart resumes from this checkpoint).  ``metrics`` feeds a
        keep-best manager's retention."""
        self._flush_pending()
        self._manager.save(step, state, force=True, metrics=metrics)
        self._manager.wait()
        logger.warning("preemption save complete at step %d", step)
        obs.record_event("preemption_save", step=step)
        flight = obs.default_recorder()
        if flight is not None:  # the process is about to exit: persist now
            flight.dump(reason="preemption")
        ledger = obs.goodput.default_ledger()
        if ledger is not None:
            # close the generation as preempted NOW (the launcher kills the
            # process next); a later clean close cannot overwrite it
            ledger.close(ended="preempted")
        if self._on_exit is not None:
            self._on_exit()

    def reset(self) -> None:
        """Re-arm after an in-process resume: the consumed notice must not
        make every later ``should_save`` fire."""
        self._flag.clear()
        self._pending = None
        self._recorded = False

    def uninstall(self) -> None:
        for sig, prev in self._installed:
            signal.signal(sig, prev)
        self._installed.clear()
