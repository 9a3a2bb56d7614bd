"""The port's multi-process runner (``testing/multi_process_runner.py``)
against the JAX package's, with no process spawned.

A thread-backed stand-in replaces the ``spawn`` context in both runners
(as ``tests/test_torch_coordinator.py`` stands in for the coordinator's):
each "process" runs the child's main in a thread, ``kill`` marks it dead
with SIGKILL's exit code, and the result queue is bounded to one item, so
a task blocks on its put until the parent reads, as a child blocks on a
big return value in its queue's feeder thread.  Through it ``join``'s
drain, timeout, expected-kill and failure paths give the same outcomes
in both packages.  The env each task gets resolves, through the port's
``parallel.bootstrap.resolve_cluster``, to its rank, the world and the
coordinator's address; the child starts the process group with the
backend the caller named, and a runner that would start one without a
backend refuses; ``pick_unused_port`` never repeats.
"""

import os
import queue
import threading

import pytest

from distributedtensorflow_tpu.testing import multi_process_runner as jmpr
from distributedtensorflow_tpu_torch.parallel import bootstrap
from distributedtensorflow_tpu_torch.testing import multi_process_runner as mpr

RUNNERS = {"jax": jmpr, "port": mpr}
RELEASE = threading.Event()  # lets the stand-in's blocked "children" end


class _ThreadProcess:
    """``multiprocessing.Process`` over a thread: ``kill`` cannot stop
    the thread, so it marks the task dead (exit code -9) and the thread
    ends when the test releases it."""

    made: list = []

    def __init__(self, target, args, name):
        self.name, self._target, self._args = name, target, args
        self.exitcode = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        _ThreadProcess.made.append(self)

    def _run(self):
        try:
            self._target(*self._args)
            code = 0
        except BaseException:  # the child's raise: a nonzero exit
            code = 1
        if self.exitcode is None:
            self.exitcode = code

    def start(self):
        self._thread.start()

    def is_alive(self):
        return self.exitcode is None and self._thread.is_alive()

    def kill(self):
        if self.exitcode is None:
            self.exitcode = -9

    def join(self, timeout=None):
        if self.exitcode is None:
            self._thread.join(timeout)


class _ThreadContext:
    Process = _ThreadProcess

    @staticmethod
    def Queue():
        return queue.Queue(maxsize=1)


@pytest.fixture
def stand_in(monkeypatch):
    """Both runners on the thread stand-in; the children's env updates
    land in a copy of the environment."""
    _ThreadProcess.made = []
    RELEASE.clear()
    monkeypatch.setattr(os, "environ", dict(os.environ))
    for mod in RUNNERS.values():
        monkeypatch.setattr(mod, "_mp", _ThreadContext)
    yield
    RELEASE.set()


def _value(task_id, size):
    return task_id, b"x" * size


def _fail_one(task_id):
    if task_id == 1:
        raise ValueError("task 1 failed")
    return task_id


def _hang_one(task_id):
    if task_id == 1:
        RELEASE.wait(60)
    return task_id


def _runner(pkg, fn, n, **kw):
    return RUNNERS[pkg].MultiProcessRunner(fn, n, init_distributed=False,
                                           **kw)


@pytest.mark.parametrize("pkg", sorted(RUNNERS))
def test_join_drains_while_waiting(stand_in, pkg):
    """Three tasks return through a queue of one slot: join reads while
    they run, or the second and third never finish."""
    res = _runner(pkg, _value, 3, args=(1 << 16,)).start().join(timeout=30)
    assert res.return_values == {i: (i, b"x" * (1 << 16)) for i in range(3)}
    assert res.failures == {} and res.exit_codes == {0: 0, 1: 0, 2: 0}


@pytest.mark.parametrize("pkg", sorted(RUNNERS))
def test_a_failing_task_raises_unexpected_exit(stand_in, pkg):
    mod = RUNNERS[pkg]
    with pytest.raises(mod.UnexpectedSubprocessExitError) as e:
        _runner(pkg, _fail_one, 2).start().join(timeout=30)
    res = e.value.result
    assert res.return_values == {0: 0}
    assert res.failures == {1: "ValueError('task 1 failed')"}
    assert res.exit_codes == {0: 0, 1: 1}


@pytest.mark.parametrize("expected", [True, False])
@pytest.mark.parametrize("pkg", sorted(RUNNERS))
def test_killed_task_is_an_expected_exit(stand_in, pkg, expected):
    mod = RUNNERS[pkg]
    runner = _runner(pkg, _hang_one, 2).start()
    runner.terminate(1, expected=expected)
    if expected:
        res = runner.join(timeout=30)
    else:
        with pytest.raises(mod.UnexpectedSubprocessExitError) as e:
            runner.join(timeout=30)
        res = e.value.result
    assert res.return_values == {0: 0} and res.exit_codes == {0: 0, 1: -9}


@pytest.mark.parametrize("pkg", sorted(RUNNERS))
def test_timeout_kills_the_stragglers(stand_in, pkg):
    mod = RUNNERS[pkg]
    with pytest.raises(mod.SubprocessTimeoutError, match="cluster-task-1") \
            as e:
        _runner(pkg, _hang_one, 2).start().join(timeout=0.5)
    assert e.value.result.exit_codes == {0: 0, 1: -9}
    assert e.value.result.return_values == {0: 0}


def test_task_env_resolves_to_rank_world_and_address(stand_in):
    runner = mpr.MultiProcessRunner(
        _value, 3, args=(1,), init_distributed=False,
        env={"EXTRA": "1"}, per_task_env=[{}, {"LOCAL_RANK": "0"}, {}])
    envs = [p._args[2] for p in _ThreadProcess.made]
    port = envs[0]["MASTER_PORT"]
    for rank, env in enumerate(envs):
        cluster = bootstrap.resolve_cluster(env)
        assert (cluster.process_id, cluster.num_processes) == (rank, 3)
        assert cluster.coordinator_address == f"localhost:{port}"
        assert cluster.is_multiprocess and env["EXTRA"] == "1"
    assert envs[1]["LOCAL_RANK"] == "0" and "LOCAL_RANK" not in envs[0]
    assert mpr.task_env(2, 4, 1234, per_task={"RANK": "3"})["RANK"] == "3"
    runner.start().join(timeout=30)


def test_children_start_the_named_backend(stand_in, monkeypatch):
    started = []
    monkeypatch.setattr(bootstrap, "initialize",
                        lambda cluster=None, *, backend: started.append(
                            (backend, os.environ["WORLD_SIZE"])))
    res = mpr.run(_value, 2, args=(1,), backend="gloo", timeout=30)
    assert sorted(res.return_values) == [0, 1]
    assert started == [("gloo", "2")] * 2
    with pytest.raises(ValueError, match="backend"):
        mpr.MultiProcessRunner(_value, 2)


def test_the_runner_spawns_and_ports_never_repeat():
    assert mpr._mp.get_start_method() == "spawn"
    ports = [mpr.pick_unused_port() for _ in range(200)]
    assert len(set(ports)) == 200
    assert set(ports) <= mpr._handed_out_ports
