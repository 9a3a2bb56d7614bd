"""Multi-process cluster runner for distributed checks.

Twin of ``distributedtensorflow_tpu/testing/multi_process_runner.py``
(the reference's ``MultiProcessRunner``,
``tf/python/distribute/multi_process_runner.py:107``): one OS process of
the ``spawn`` context per cluster task, the cluster's env written into
each, every task's return value collected, a timeout enforced, and
failures injected by killing tasks mid-run (``SubprocessTimeoutError``
:1173, ``UnexpectedSubprocessExitError`` :1191).

The differences from the JAX runner:

- the env is torchrun's (``MASTER_ADDR``, ``MASTER_PORT``,
  ``WORLD_SIZE``, ``RANK``), which ``parallel.bootstrap.resolve_cluster``
  reads first, where JAX's writes its coordination-service variables;
  a caller may pass any other env (``TF_CONFIG``, ...) to drive the
  resolver chain;
- ``init_distributed`` starts the default process group through
  ``bootstrap.initialize(backend=...)``, and the backend is the caller's
  ``backend`` keyword, never guessed (two tasks on one card share gloo:
  NCCL refuses two ranks on one device);
- the children see the devices their parent sees and ``fn`` picks its
  own, where JAX's forces its children onto the CPU (a TPU host's chip
  belongs to one process).  Several processes may share one card.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import queue as queue_lib
import socket
import time
from typing import Any, Callable, Mapping, Sequence

_mp = mp.get_context("spawn")  # never fork: the parent may hold a CUDA context


class SubprocessTimeoutError(RuntimeError):
    """join() timed out; the stragglers were killed."""

    def __init__(self, msg: str, result: "MultiProcessResult"):
        super().__init__(msg)
        self.result = result


class UnexpectedSubprocessExitError(RuntimeError):
    """A task exited nonzero (and was not an expected kill)."""

    def __init__(self, msg: str, result: "MultiProcessResult"):
        super().__init__(msg)
        self.result = result


@dataclasses.dataclass
class MultiProcessResult:
    """Per-task outcomes.

    ``return_values[i]`` holds task i's return value (missing if it died
    or raised); ``failures[i]`` the ``repr`` of the exception a failed
    task raised (missing if it succeeded or was killed before
    reporting)."""

    return_values: dict[int, Any]
    failures: dict[int, str]
    exit_codes: dict[int, int | None]


_handed_out_ports: set[int] = set()


def pick_unused_port() -> int:
    """A free localhost port, never repeating within this process (the
    socket closes before the caller binds, so an unrelated process could
    still take it; the set closes the likelier race of two calls getting
    the same ephemeral port back)."""
    while True:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        if port not in _handed_out_ports:
            _handed_out_ports.add(port)
            return port


def task_env(task_id: int, num_processes: int, port: int,
             env: Mapping[str, str] | None = None,
             per_task: Mapping[str, str] | None = None) -> dict[str, str]:
    """The env task ``task_id`` of ``num_processes`` gets: torchrun's
    variables for a coordinator at ``localhost:port``, then the caller's
    ``env`` and the task's own ``per_task`` entries over them."""
    out = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
           "WORLD_SIZE": str(num_processes)}
    out.update(env or {})
    out["RANK"] = str(task_id)
    out.update(per_task or {})
    return out


def _child_main(fn: Callable, task_id: int, env: Mapping[str, str],
                init_distributed: bool, backend: str | None, args: tuple,
                kwargs: dict, result_queue) -> None:
    os.environ.update(env)
    try:
        if init_distributed:
            from ..parallel import bootstrap

            bootstrap.initialize(backend=backend)
        value = fn(task_id, *args, **kwargs)
        result_queue.put((task_id, True, value))
    except BaseException as e:  # noqa: BLE001 — reported to the parent
        result_queue.put((task_id, False, repr(e)))
        raise


class MultiProcessRunner:
    """Run ``fn(task_id, *args, **kwargs)`` in ``num_processes`` cluster
    tasks.

    With ``init_distributed`` (the default) each child starts the default
    process group over the cluster it resolves from the env this runner
    wrote (or any env the caller injected) with ``backend`` ("gloo" or
    "nccl"), which the caller must name."""

    def __init__(
        self,
        fn: Callable,
        num_processes: int,
        *,
        args: tuple = (),
        kwargs: dict | None = None,
        env: Mapping[str, str] | None = None,
        per_task_env: Sequence[Mapping[str, str]] | None = None,
        init_distributed: bool = True,
        backend: str | None = None,
        timeout: float = 300.0,
    ):
        if init_distributed and backend is None:
            raise ValueError(
                "init_distributed needs a process-group backend: pass "
                "backend='gloo' or 'nccl'")
        self._n = num_processes
        self._timeout = timeout
        self._queue = _mp.Queue()
        self._expected_kills: set[int] = set()
        port = pick_unused_port()
        self._procs: list = []
        for i in range(num_processes):
            child_env = task_env(i, num_processes, port, env,
                                 per_task_env[i] if per_task_env else None)
            self._procs.append(_mp.Process(
                target=_child_main,
                args=(fn, i, child_env, init_distributed, backend, args,
                      kwargs or {}, self._queue),
                name=f"cluster-task-{i}"))

    def start(self) -> "MultiProcessRunner":
        for p in self._procs:
            p.start()
        return self

    def terminate(self, task_id: int, *, expected: bool = True) -> None:
        """Fault injection: SIGKILL a task (the reference's process-kill
        path)."""
        if expected:
            self._expected_kills.add(task_id)
        self._procs[task_id].kill()

    def join(self, timeout: float | None = None) -> MultiProcessResult:
        timeout = self._timeout if timeout is None else timeout
        deadline = time.monotonic() + timeout
        values: dict[int, Any] = {}
        failures: dict[int, str] = {}
        # Drain while waiting: a child whose return value exceeds the
        # queue's pipe buffer blocks in its feeder thread until the parent
        # reads, so joining before draining would deadlock (then falsely
        # time out).
        while (any(p.is_alive() for p in self._procs)
               and time.monotonic() < deadline):
            self._drain(values, failures, wait=0.05)
        for p in self._procs:
            p.join(max(0.0, deadline - time.monotonic()))
        timed_out = [p for p in self._procs if p.is_alive()]
        for p in timed_out:
            p.kill()
            p.join(10)
        self._drain(values, failures)
        result = MultiProcessResult(
            return_values=values, failures=failures,
            exit_codes={i: p.exitcode for i, p in enumerate(self._procs)})
        if timed_out:
            raise SubprocessTimeoutError(
                f"tasks {[p.name for p in timed_out]} timed out after "
                f"{timeout}s", result)
        bad = {i: code for i, code in result.exit_codes.items()
               if code != 0 and i not in self._expected_kills}
        if bad:
            raise UnexpectedSubprocessExitError(
                f"tasks exited nonzero: {bad}; failures: {failures}", result)
        return result

    def _drain(self, values: dict[int, Any], failures: dict[int, str],
               wait: float = 0.0) -> None:
        block = wait > 0
        while True:
            try:
                task_id, ok, value = self._queue.get(block, wait or None)
            except queue_lib.Empty:
                return
            block = False  # only the first read waits
            if ok:
                values[task_id] = value
            else:
                failures[task_id] = value


def run(
    fn: Callable,
    num_processes: int,
    *,
    args: tuple = (),
    timeout: float = 300.0,
    env: Mapping[str, str] | None = None,
    per_task_env: Sequence[Mapping[str, str]] | None = None,
    init_distributed: bool = True,
    backend: str | None = None,
) -> MultiProcessResult:
    """One shot (the reference's ``multi_process_runner.run``, :1245)."""
    return MultiProcessRunner(
        fn, num_processes, args=args, timeout=timeout, env=env,
        per_task_env=per_task_env, init_distributed=init_distributed,
        backend=backend,
    ).start().join()
