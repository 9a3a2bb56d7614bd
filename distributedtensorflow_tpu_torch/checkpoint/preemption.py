"""Preemption-aware checkpointing.

Twin of ``distributedtensorflow_tpu/checkpoint/preemption.py``
(``:41-185``).  The preemption notice (SIGTERM on GCE and Borg) is caught
per process and only sets a flag.  At a step boundary
:meth:`PreemptionHandler.should_save` turns the flags of every rank into
one answer, the same on all of them, and :meth:`save_and_exit` forces a
save of that step and waits for its commit; the launcher's restart
resumes from it.  JAX's counter and flight-recorder events are left out
until the port has ``obs`` (ROADMAP.md).
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Callable

from ..parallel import collectives
from .manager import CheckpointManager, group_max

logger = logging.getLogger(__name__)


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
        self._installed = []
        for sig in signals:
            try:
                prev = signal.signal(sig, self._on_signal)
                self._installed.append((sig, prev))
            except ValueError:  # not on the main thread (tests)
                pass

    def _on_signal(self, signum, frame):
        # a signal handler interrupts the main thread wherever it is:
        # only set the flag, and act at the next step boundary
        logger.warning("preemption signal %s received", signum)
        self._flag.set()

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()

    @property
    def manager(self) -> CheckpointManager:
        """The manager preemption saves go through."""
        return self._manager

    def trigger(self) -> None:
        """Programmatic preemption (tests, external watchers)."""
        self._flag.set()

    def should_save(self, step: int | None = None) -> bool:
        """Whether to save and stop at this step boundary (call it every
        step).  One process: the local flag.  Over a group of ranks: the
        flag of any rank, found by one MAX all-reduce of an int, on every
        ``poll_every``-th step only.  Every rank must enter the collective
        at the same steps, so the schedule is a pure function of ``step``;
        a flag set in between waits for the next poll step.  ``step=None``
        polls now."""
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
        self._manager.save(step, state, force=True, metrics=metrics)
        self._manager.wait()
        logger.warning("preemption save complete at step %d", step)
        if self._on_exit is not None:
            self._on_exit()

    def reset(self) -> None:
        """Re-arm after an in-process resume: the consumed notice must not
        make every later ``should_save`` fire."""
        self._flag.clear()

    def uninstall(self) -> None:
        for sig, prev in self._installed:
            signal.signal(sig, prev)
        self._installed.clear()
