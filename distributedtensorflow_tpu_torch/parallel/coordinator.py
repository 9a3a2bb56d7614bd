"""Coordinator: async closure dispatch with failure-transparent retry.

Twin of ``distributedtensorflow_tpu/parallel/coordinator.py``, framework
free as the reference is (the reference's ``ClusterCoordinator``:
``Closure``, ``_CoordinatedClosureQueue``, ``WorkerPreemptionHandler``,
``Worker``, ``ClusterCoordinator.schedule/join/fetch`` and
``create_per_worker_dataset``): a dispatcher that fans closures out to a
pool of workers (eval jobs on :meth:`TrainState.snapshot` copies, data
preprocessing, metric export, host-side side computations) while the
main thread keeps driving the device loop.

- ``schedule`` is non-blocking and returns a :class:`RemoteValue`;
- a worker failing with a *retryable* error re-queues the closure onto
  another worker, at most ``max_retries`` times;
- a closure failing with an *application* error parks the error, cancels
  the closures still queued and re-raises it at the next
  ``schedule``/``join``;
- ``join`` barriers on queue drain; ``done`` polls it;
- ``create_per_worker_dataset`` + ``per_worker_value`` build one value
  per worker, resolved to the right worker's copy inside closures.

``use_processes=True`` backs each worker with an OS process of the
``spawn`` context: the parent may already hold a CUDA context, which a
forked child must never inherit, and a worker process touches CUDA only
if its closure does.  A dead process surfaces as
:class:`WorkerUnavailableError`, the closure re-queues, and the process
respawns behind an exponential backoff, at most ``max_respawns`` times.

Telemetry (the port's registry): ``coordinator_closures_{scheduled,
finished,retried,failed}_total``, ``coordinator_queue_depth``,
``coordinator_wasted_seconds{outcome=}``, ``worker_respawns_total
{worker=}`` and the flight events ``coordinator_retry``,
``coordinator_failure`` and ``worker_respawn`` that ``obs.goodput``
counts.
"""

from __future__ import annotations

import collections
import logging
import multiprocessing as mp
import os
import signal
import threading
import time
from typing import Any, Callable, Generic, Iterable, Iterator, TypeVar

from .. import obs

logger = logging.getLogger(__name__)

# Registry metrics (obs/): dispatch health of every Coordinator in the
# process, one shared family with no per-instance labels — the queue-depth
# gauge is the "is host-side work backing up" signal.
_M_SCHEDULED = obs.counter(
    "coordinator_closures_scheduled_total", "closures accepted by schedule()"
)
_M_FINISHED = obs.counter(
    "coordinator_closures_finished_total", "closures completed successfully"
)
_M_RETRIED = obs.counter(
    "coordinator_closures_retried_total",
    "closure re-queues after a retryable worker failure",
)
_M_FAILED = obs.counter(
    "coordinator_closures_failed_total", "closures parked as application errors"
)
_M_QUEUE_DEPTH = obs.gauge(
    "coordinator_queue_depth", "closures waiting for a worker"
)
_M_WASTED_S = obs.histogram(
    "coordinator_wasted_seconds",
    "seconds a closure attempt ran before being discarded by a retry or "
    "failure (host-side badput; the goodput report counts the matching "
    "coordinator_retry/failure flight events per generation)",
)
_M_RESPAWNS = obs.counter(
    "worker_respawns_total",
    "process-backed worker respawns after a worker death, by worker id "
    "(a climbing single-worker rate = a crash-looping worker approaching "
    "its respawn budget)",
)

T = TypeVar("T")


class ClosureAborted(RuntimeError):
    """Raised by fetch() on closures cancelled after another closure failed."""


class WorkerUnavailableError(RuntimeError):
    """Retryable transport error — the reference's ``UnavailableError``.

    Raise this (or register other types via ``retryable_exceptions``) from a
    closure to signal "the worker died, not the computation": the closure is
    transparently re-scheduled on another worker.
    """


class RemoteValue(Generic[T]):
    """Future for a scheduled closure's result (reference :1695 ``fetch``)."""

    def __init__(self) -> None:
        self._ready = threading.Event()
        self._value: T | None = None
        self._error: BaseException | None = None

    def _set_value(self, value: T) -> None:
        self._value = value
        self._ready.set()

    def _set_error(self, err: BaseException) -> None:
        self._error = err
        self._ready.set()

    def fetch(self, timeout: float | None = None) -> T:
        if not self._ready.wait(timeout):
            raise TimeoutError("RemoteValue not ready")
        if self._error is not None:
            raise self._error
        return self._value

    def done(self) -> bool:
        return self._ready.is_set()


class Closure:
    """A scheduled unit of work (reference ``Closure``, :193)."""

    __slots__ = ("fn", "args", "kwargs", "output", "attempts")

    def __init__(self, fn: Callable[..., Any], args: tuple, kwargs: dict):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.output: RemoteValue = RemoteValue()
        self.attempts = 0

    def execute(self, resolve: Callable[[Any], Any]) -> Any:
        args = tuple(resolve(a) for a in self.args)
        kwargs = {k: resolve(v) for k, v in self.kwargs.items()}
        return self.fn(*args, **kwargs)


class _ClosureQueue:
    """Bounded closure queue with in-flight tracking and error parking.

    Reference ``_CoordinatedClosureQueue`` (:322): ``put`` blocks when full
    (backpressure), ``wait`` barriers on drain, the first application error
    stops intake, cancels queued closures, and re-raises at the next
    coordinator call.
    """

    def __init__(self, maxsize: int = 256):
        self._queue: collections.deque[Closure] = collections.deque()
        self._maxsize = maxsize
        self._inflight = 0
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._drained = threading.Condition(self._lock)
        self._error: BaseException | None = None
        self._closed = False

    def put(self, closure: Closure) -> None:
        with self._not_full:
            self.raise_if_error()
            while len(self._queue) >= self._maxsize and not self._closed:
                self._not_full.wait()
                self.raise_if_error()
            if self._closed:
                raise RuntimeError("coordinator is shut down")
            self._queue.append(closure)
            _M_QUEUE_DEPTH.set(len(self._queue))
            self._not_empty.notify()

    def get(self, timeout: float = 0.1) -> Closure | None:
        with self._not_empty:
            if not self._queue:
                self._not_empty.wait(timeout)
            if not self._queue:
                return None
            closure = self._queue.popleft()
            self._inflight += 1
            _M_QUEUE_DEPTH.set(len(self._queue))
            self._not_full.notify()
            return closure

    def put_back(self, closure: Closure) -> None:
        """Re-queue a closure whose worker died (retry path)."""
        with self._lock:
            self._inflight -= 1
            if self._error is None and not self._closed:
                self._queue.appendleft(closure)
                _M_QUEUE_DEPTH.set(len(self._queue))
                self._not_empty.notify()
            else:
                closure.output._set_error(ClosureAborted("coordinator errored"))
                self._drained.notify_all()

    def mark_finished(self) -> None:
        with self._lock:
            self._inflight -= 1
            if not self._queue and self._inflight == 0:
                self._drained.notify_all()

    def mark_failed(self, err: BaseException) -> None:
        """Application error: park it, cancel everything queued."""
        with self._lock:
            self._inflight -= 1
            if self._error is None:
                self._error = err
            for closure in self._queue:
                closure.output._set_error(ClosureAborted("cancelled"))
            self._queue.clear()
            _M_QUEUE_DEPTH.set(0)
            self._not_full.notify_all()
            self._drained.notify_all()

    def raise_if_error(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def wait(self, timeout: float | None = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._drained:
            while (self._queue or self._inflight) and self._error is None:
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    break
                self._drained.wait(remaining)
            self.raise_if_error()
            return not self._queue and self._inflight == 0

    def done(self) -> bool:
        with self._lock:
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            return not self._queue and self._inflight == 0

    def close(self) -> None:
        with self._lock:
            self._closed = True
            for closure in self._queue:
                closure.output._set_error(ClosureAborted("coordinator shut down"))
            self._queue.clear()
            _M_QUEUE_DEPTH.set(0)
            self._not_empty.notify_all()
            self._not_full.notify_all()
            self._drained.notify_all()


class PerWorker(Generic[T]):
    """One value per worker; closures see their own worker's copy.

    Reference: per-worker datasets/values (``create_per_worker_dataset``
    :1604) — each worker builds its own iterator so data pipelines are not
    shared across workers.
    """

    def __init__(self, build_fn: Callable[[int], T], n_workers: int):
        self._build_fn = build_fn
        self._values: dict[int, T] = {}
        self._lock = threading.Lock()
        self._n = n_workers

    def _resolve(self, worker_id: int) -> T:
        with self._lock:
            if worker_id not in self._values:
                self._values[worker_id] = self._build_fn(worker_id)
            return self._values[worker_id]


def _subprocess_worker_main(conn, status_port: int | None = None) -> None:
    """Loop of a process-backed worker: recv (fn, args, kwargs), send result.

    ``status_port`` (0 = ephemeral) embeds an ``obs.StatusServer`` in the
    child so the chief's FleetAggregator can scrape its ``/varz`` — the
    bound port (or None on failure) is sent to the parent as a
    ``("status_port", port)`` handshake message BEFORE the closure loop
    starts, so it can never interleave with an execute round-trip."""
    server = None
    if status_port is not None:
        state = {"closures_done": 0, "pid": os.getpid()}
        try:
            from ..obs.server import StatusServer  # noqa: PLC0415

            server = StatusServer(
                status_port,
                status_fn=lambda: {"coordinator_worker": dict(state)},
            ).start()
            conn.send(("status_port", server.port))
        except Exception:  # bind failure — degrade, the worker still works
            conn.send(("status_port", None))
    else:
        state = {"closures_done": 0}
    while True:
        try:
            msg = conn.recv()
        except (EOFError, KeyboardInterrupt):
            return
        if msg is None:
            return
        fn, args, kwargs = msg
        try:
            result = fn(*args, **kwargs)
            state["closures_done"] += 1
            conn.send(("ok", result))
        except BaseException as e:  # noqa: BLE001 — shipped to the parent
            try:
                conn.send(("err", e))
            except Exception:  # unpicklable exception: ship the repr
                conn.send(("err", RuntimeError(repr(e))))


class _SubprocessExecutor:
    """A persistent worker OS process executing pickled closures.

    The process analogue of the reference's remote eager workers (§3.3):
    real isolation, real death.  A dead child surfaces as
    :class:`WorkerUnavailableError` — exactly the retryable signal the
    coordinator's re-queue path expects — and the executor respawns for the
    next closure.  Closures and their resolved args must be picklable
    (module-level functions; no PerWorker iterators).

    Respawns are BOUNDED (resilience satellite): a crash-looping worker —
    e.g. one whose host is out of memory, where every fresh process dies
    the same death — used to respawn forever at full speed.  A death now
    *schedules* the respawn behind an exponentially-backed-off deadline
    (``respawn_backoff_s`` base, doubling, clamped at
    ``respawn_backoff_max_s``); the actual spawn happens lazily at the
    next :meth:`execute` past the deadline, and executes arriving during
    the backoff fail fast with :class:`WorkerUnavailableError` — the
    dying worker must never stall the retry path that re-queues its
    closure onto healthy workers (nobody sleeps holding the executor
    lock).  Each scheduled respawn emits a ``worker_respawn`` flight
    event plus ``worker_respawns_total{worker=}``; after ``max_respawns``
    the executor goes permanently dead and its closures keep failing
    fast onto the surviving workers.
    """

    def __init__(self, worker_id: int, *, max_respawns: int = 8,
                 respawn_backoff_s: float = 0.5,
                 respawn_backoff_max_s: float = 30.0,
                 status_port: int | None = None,
                 defer_status_handshake: bool = False):
        self.worker_id = worker_id
        self._ctx = mp.get_context("spawn")
        self._lock = threading.Lock()
        self._max_respawns = max(0, int(max_respawns))
        self._backoff_s = max(0.0, float(respawn_backoff_s))
        self._backoff_max_s = max(0.0, float(respawn_backoff_max_s))
        self._status_port = status_port
        #: ``host:port`` of the child's embedded StatusServer (fleet
        #: scrape target), or None — refreshed on every (re)spawn.
        self.status_addr: str | None = None
        self.respawns = 0
        self.last_backoff_s = 0.0
        self._dead = False
        #: monotonic deadline of a scheduled-but-not-yet-performed respawn
        #: (None = a live process exists).
        self._spawn_not_before: float | None = None
        # defer_status_handshake: the Coordinator spawns ALL executors
        # first (children import torch concurrently), then collects the
        # handshakes — otherwise startup serializes on N torch imports.
        self._spawn(wait_handshake=not defer_status_handshake)

    def _spawn(self, *, wait_handshake: bool = True) -> None:
        self._conn, child = self._ctx.Pipe()
        self._proc = self._ctx.Process(
            target=_subprocess_worker_main,
            args=(child, self._status_port), daemon=True,
            name=f"coordinator-proc-{self.worker_id}",
        )
        self._proc.start()
        child.close()
        self.status_addr = None
        if self._status_port is not None and wait_handshake:
            self.wait_status_handshake()

    def wait_status_handshake(self, timeout: float = 60.0) -> None:
        """Consume the child's ``("status_port", port)`` handshake (the
        spawn context re-imports this module — and torch with it — in
        the child, so allow a generous import window).  A handshake that
        outlives the poll is consumed safely by execute()'s tag loop
        instead — results never shift by one message."""
        if self._status_port is None:
            return
        try:
            if self._conn.poll(timeout):
                tag, port = self._conn.recv()
                if tag == "status_port" and port:
                    self.status_addr = f"127.0.0.1:{int(port)}"
        except (EOFError, OSError):
            pass

    @property
    def pid(self) -> int:
        return self._proc.pid

    def backoff_remaining(self) -> float | None:
        """Seconds until this executor may respawn (0.0 = ready), or None
        when it is permanently dead.  Lock-free on purpose: the dispatch
        thread polls this while another thread may hold the executor lock
        inside a long closure; plain attribute reads are safe and a stale
        answer only shifts a pop by one poll."""
        if self._dead:
            return None
        t = self._spawn_not_before
        if t is None:
            return 0.0
        return max(t - time.monotonic(), 0.0)

    def execute(self, fn, args, kwargs):
        with self._lock:
            if self._dead:
                raise WorkerUnavailableError(
                    f"worker process {self.worker_id} is dead (respawn "
                    f"budget of {self._max_respawns} exhausted)"
                )
            if self._spawn_not_before is not None:
                # A death scheduled a respawn: spawn once the backoff
                # deadline passes; until then fail fast so the closure
                # re-queues onto a healthy worker immediately.
                if time.monotonic() < self._spawn_not_before:
                    raise WorkerUnavailableError(
                        f"worker process {self.worker_id} is respawning "
                        f"(backoff {self.last_backoff_s:.2f}s after death "
                        f"{self.respawns}/{self._max_respawns})"
                    )
                self._spawn_not_before = None
                # No handshake wait on the respawn path: execute's tag
                # loop below consumes it — blocking the failure path 60s
                # would stall exactly the retry the re-queue depends on.
                self._spawn(wait_handshake=False)
            try:
                self._conn.send((fn, args, kwargs))
                status, payload = self._conn.recv()
                while status == "status_port":
                    # Late status handshake (the spawn-time poll gave up
                    # before the child finished binding): consume it here
                    # so closure results can never shift by one message.
                    self.status_addr = (
                        f"127.0.0.1:{int(payload)}" if payload else None
                    )
                    status, payload = self._conn.recv()
            except (EOFError, OSError) as e:
                self._respawn()
                raise WorkerUnavailableError(
                    f"worker process {self.worker_id} died: {e!r}"
                ) from e
        if status == "err":
            raise payload
        return payload

    def _respawn(self) -> None:
        """Reap the dead process and SCHEDULE its replacement (or go
        permanently dead past the budget).  Never sleeps, never spawns —
        both would stall the caller's failure path, which healthy workers
        are waiting on to pick up the re-queued closure."""
        try:
            self._conn.close()
        except OSError:
            pass
        if self._proc.is_alive():
            self._proc.kill()
        self._proc.join(timeout=5)
        if self.respawns >= self._max_respawns:
            self._dead = True
            logger.error(
                "worker %d exhausted its respawn budget (%d); leaving it "
                "dead — closures re-queue onto surviving workers",
                self.worker_id, self._max_respawns,
            )
            return
        self.respawns += 1
        _M_RESPAWNS.inc(worker=str(self.worker_id))
        obs.record_event(
            "worker_respawn", worker=self.worker_id, respawn=self.respawns,
            budget=self._max_respawns,
        )
        self.last_backoff_s = min(
            self._backoff_s * (2 ** (self.respawns - 1)),
            self._backoff_max_s,
        )
        self._spawn_not_before = time.monotonic() + self.last_backoff_s
        logger.warning(
            "worker %d death %d/%d: respawn scheduled in %.2fs",
            self.worker_id, self.respawns, self._max_respawns,
            self.last_backoff_s,
        )

    def kill(self) -> None:
        """Fault injection: SIGKILL the worker process."""
        os.kill(self._proc.pid, signal.SIGKILL)

    def close(self) -> None:
        # Don't block shutdown behind a worker thread parked in recv() on a
        # long/hung closure: bounded lock wait, then escalate to kill.
        got = self._lock.acquire(timeout=1.0)
        try:
            if got:
                try:
                    self._conn.send(None)  # graceful: child loop exits
                    self._conn.close()
                except OSError:
                    pass
        finally:
            if got:
                self._lock.release()
        self._proc.join(timeout=5 if got else 0.1)
        if self._proc.is_alive():
            self._proc.kill()
            self._proc.join(timeout=5)


class _Worker(threading.Thread):
    """Dispatch thread (reference ``Worker``, :1027): pops and executes.

    A retryable failure re-queues the closure and "restarts" the worker
    (the reference re-establishes the remote connection; here the thread
    just clears its per-worker state and keeps serving).
    """

    def __init__(self, worker_id: int, coord: "Coordinator"):
        super().__init__(name=f"coordinator-worker-{worker_id}", daemon=True)
        self.worker_id = worker_id
        self._coord = coord
        self.failures = 0

    def run(self) -> None:
        queue = self._coord._queue
        while not self._coord._stopping.is_set():
            executor_state = self._coord._executor_for(self.worker_id)
            if executor_state is not None:
                rem = executor_state.backoff_remaining()
                if rem is None:
                    # Permanently dead executor: de-prioritize hard so
                    # surviving workers win every pop; if NO survivor
                    # exists the pop below still fails closures fast
                    # enough (bounded by max_retries) to surface the
                    # error instead of hanging the queue.
                    time.sleep(0.2)
                elif rem > 0:
                    # Respawn backoff window: do not pop AT ALL — a
                    # popped closure would insta-fail back into the
                    # queue, burning its retry budget against a worker
                    # that is known-down (healthy workers pick it up
                    # instead).
                    time.sleep(min(rem, 0.1))
                    continue
            closure = queue.get()
            if closure is None:
                continue
            if self._coord._failed_workers_see_unavailable(self.worker_id):
                # Fault injection: this worker is "preempted" — behave like a
                # dead remote: the closure must move to another worker.
                self.failures += 1
                closure.attempts += 1
                queue.put_back(closure)
                self._coord._recover_worker(self.worker_id)
                continue
            def resolve(v: Any) -> Any:
                if isinstance(v, PerWorker):
                    return v._resolve(self.worker_id)
                return v
            executor = self._coord._executor_for(self.worker_id)
            attempt_t0 = time.perf_counter()
            try:
                if executor is not None:
                    result = executor.execute(
                        closure.fn,
                        tuple(resolve(a) for a in closure.args),
                        {k: resolve(v) for k, v in closure.kwargs.items()},
                    )
                else:
                    result = closure.execute(resolve)
            except self._coord._retryable as e:
                self.failures += 1
                closure.attempts += 1
                _M_RETRIED.inc()
                _M_WASTED_S.observe(
                    time.perf_counter() - attempt_t0, outcome="retry"
                )
                if closure.attempts >= self._coord._max_retries:
                    err = RuntimeError(
                        f"closure failed {closure.attempts} retryable attempts"
                    )
                    err.__cause__ = e
                    closure.output._set_error(err)
                    queue.mark_failed(err)
                    _M_FAILED.inc()  # retry exhaustion is a permanent failure
                    obs.record_event(
                        "coordinator_failure", worker=self.worker_id,
                        attempts=closure.attempts, error="retries exhausted",
                    )
                    continue
                logger.warning(
                    "worker %d unavailable (%s); re-queueing closure "
                    "(attempt %d)", self.worker_id, e, closure.attempts,
                )
                # Flight marker: a retried closure is exactly the kind of
                # "what was happening before the hang" breadcrumb the
                # post-mortem wants (a dying worker pool precedes a stall).
                obs.record_event(
                    "coordinator_retry", worker=self.worker_id,
                    attempt=closure.attempts, error=repr(e)[:200],
                )
                queue.put_back(closure)
            except BaseException as e:  # noqa: BLE001 — parked, re-raised at join
                closure.output._set_error(e)
                queue.mark_failed(e)
                _M_FAILED.inc()
                _M_WASTED_S.observe(
                    time.perf_counter() - attempt_t0, outcome="failure"
                )
                obs.record_event(
                    "coordinator_failure", worker=self.worker_id,
                    error=repr(e)[:200],
                )
            else:
                closure.output._set_value(result)
                queue.mark_finished()
                _M_FINISHED.inc()


class Coordinator:
    """Failure-transparent closure dispatcher (reference :1399).

    Usage::

        coord = Coordinator(num_workers=4)
        rv = coord.schedule(eval_fn, (state,))
        ...            # main thread keeps training
        coord.join()   # barrier; re-raises any application error
        print(rv.fetch())
    """

    def __init__(
        self,
        num_workers: int = 1,
        *,
        queue_size: int = 256,
        retryable_exceptions: tuple[type[BaseException], ...] = (),
        max_retries: int = 16,
        use_processes: bool = False,
        max_respawns: int = 8,
        respawn_backoff_s: float = 0.5,
        respawn_backoff_max_s: float = 30.0,
        worker_status_ports: bool = False,
    ):
        """``use_processes=True`` backs each worker with a real OS process
        (the reference's remote-worker isolation): closures run out-of-
        process, a killed/crashed worker transparently re-queues its
        closure, and the pool respawns the process — at most
        ``max_respawns`` times per worker, with exponential backoff
        (``respawn_backoff_s`` base, ``respawn_backoff_max_s`` clamp), so a
        crash-looping worker cannot fork-bomb the host.  Requires picklable
        closures/args; PerWorker values stay thread-mode only.

        ``worker_status_ports=True`` (process mode only) embeds an
        ephemeral loopback ``obs.StatusServer`` in every worker process so
        the fleet aggregator can scrape them; the bound addresses are
        :meth:`worker_status_addrs`.
        """
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        if worker_status_ports and not use_processes:
            raise ValueError(
                "worker_status_ports requires use_processes=True (thread "
                "workers share this process's own StatusServer)"
            )
        self._queue = _ClosureQueue(queue_size)
        self._max_retries = max_retries
        self._stopping = threading.Event()
        self._retryable = (WorkerUnavailableError, *retryable_exceptions)
        self._failed_workers: set[int] = set()
        self._failed_lock = threading.Lock()
        self._executors: list[_SubprocessExecutor] | None = (
            [
                _SubprocessExecutor(
                    i, max_respawns=max_respawns,
                    respawn_backoff_s=respawn_backoff_s,
                    respawn_backoff_max_s=respawn_backoff_max_s,
                    status_port=0 if worker_status_ports else None,
                    # spawn everything first; handshakes collected below
                    # so the children's torch imports overlap instead
                    # of serializing Coordinator startup N-fold
                    defer_status_handshake=True,
                )
                for i in range(num_workers)
            ]
            if use_processes
            else None
        )
        if self._executors and worker_status_ports:
            for e in self._executors:
                e.wait_status_handshake()
        self._workers = [_Worker(i, self) for i in range(num_workers)]
        for w in self._workers:
            w.start()

    def _executor_for(self, worker_id: int) -> "_SubprocessExecutor | None":
        return self._executors[worker_id] if self._executors else None

    def worker_pids(self) -> list[int] | None:
        """PIDs of process-backed workers (None in thread mode)."""
        if not self._executors:
            return None
        return [e.pid for e in self._executors]

    def worker_status_addrs(self) -> list[str | None] | None:
        """Embedded StatusServer addresses of process-backed workers
        (``worker_status_ports=True``) — the fleet aggregator's scrape
        targets; None in thread mode, per-entry None where the child's
        server failed to bind."""
        if not self._executors:
            return None
        return [e.status_addr for e in self._executors]

    def kill_worker_process(self, worker_id: int) -> None:
        """Fault injection: SIGKILL a process-backed worker (its in-flight
        closure re-queues onto another worker; the process respawns)."""
        if not self._executors:
            raise RuntimeError("kill_worker_process needs use_processes=True")
        self._executors[worker_id].kill()

    @property
    def num_workers(self) -> int:
        return len(self._workers)

    def schedule(
        self, fn: Callable[..., Any], args: tuple = (), kwargs: dict | None = None
    ) -> RemoteValue:
        """Enqueue ``fn(*args)`` for some worker; non-blocking (:1493).

        Re-raises a previously failed closure's error, matching the
        reference's "error raised at the next schedule/join" contract.
        """
        closure = Closure(fn, args, kwargs or {})
        self._queue.put(closure)
        _M_SCHEDULED.inc()
        return closure.output

    def join(self, timeout: float | None = None) -> None:
        """Block until all scheduled closures finish (:1565)."""
        if not self._queue.wait(timeout):
            raise TimeoutError("coordinator join timed out")

    def done(self) -> bool:
        return self._queue.done()

    def fetch(self, values: Any) -> Any:
        """Resolve RemoteValues in a structure (:1695)."""
        if isinstance(values, RemoteValue):
            return values.fetch()
        if isinstance(values, (list, tuple)):
            return type(values)(self.fetch(v) for v in values)
        if isinstance(values, dict):
            return {k: self.fetch(v) for k, v in values.items()}
        return values

    def per_worker_value(self, build_fn: Callable[[int], T]) -> PerWorker[T]:
        return PerWorker(build_fn, len(self._workers))

    def create_per_worker_dataset(
        self, dataset_fn: Callable[[int], Iterable]
    ) -> PerWorker[Iterator]:
        """One iterator per worker (:1604); pass the result to closures."""
        return PerWorker(lambda i: iter(dataset_fn(i)), len(self._workers))

    # -- fault injection (the reference's MultiProcessRunner kill path is a
    #    process kill; for the in-process pool, preemption is simulated).

    def preempt_worker(self, worker_id: int) -> None:
        """Mark a worker dead: its next closures re-queue elsewhere."""
        with self._failed_lock:
            self._failed_workers.add(worker_id)

    def _failed_workers_see_unavailable(self, worker_id: int) -> bool:
        with self._failed_lock:
            return worker_id in self._failed_workers

    def _recover_worker(self, worker_id: int) -> None:
        with self._failed_lock:
            self._failed_workers.discard(worker_id)

    def shutdown(self) -> None:
        self._stopping.set()
        self._queue.close()
        for w in self._workers:
            w.join(timeout=5)
        if self._executors:
            for e in self._executors:
                e.close()

    def __enter__(self) -> "Coordinator":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
