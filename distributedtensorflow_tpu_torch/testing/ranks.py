"""Ranks as threads of one process, each with its own gloo group.

The port's counterpart of the reference's in-process multi-worker test
clusters (``distributedtensorflow_tpu/testing/multi_process_runner.py``
forks processes; threads start in milliseconds and share the test's
imports).  Every thread gets a bare ``ProcessGroupGloo`` over one shared
``HashStore``, so the port's collectives (which call the group's own
methods) run for real between the threads; :func:`run_mesh` adds a
mesh's subgroups over the same store.  On the CPU each thread's
backward runs in the thread itself, so a collective inside a backward
(BatchNorm's statistics) meets its peers; CUDA tensors of two threads on
one card would share the card's single autograd thread and deadlock
there, so ranks on a card are processes.

Every group, the world's and a mesh's subgroups, lives until every
thread has ended.  gloo's ``connectFullMesh`` can hand one side of a
pair its connection while the other side still finishes its handshake:
a rank whose ``fn`` returned at once (it calls no collective) and so
dropped its group then closed the pair under a peer still in its
constructor, which failed with "Connection closed by peer" on a busy
host.
"""

from __future__ import annotations

import datetime
import itertools
import threading
from typing import Any, Callable

import torch.distributed as dist


def run_mesh(fn: Callable[[int, Any], Any], spec, world: int, *,
             timeout: float = 60.0) -> list:
    """:func:`run_ranks` with ``fn(rank, mesh)``: the mesh of ``spec`` (a
    ``parallel.mesh.MeshSpec``) over the threads' world, its batch and
    model subgroups bare gloo groups over the same store (a
    ``PrefixStore`` a subgroup, as the world's)."""
    from ..parallel.mesh import build_mesh

    return run_group_ranks(
        lambda rank, group, new_group: fn(
            rank, build_mesh(spec, group, new_group)),
        world, timeout=timeout)


def run_group_ranks(fn: Callable[[int, Any, Any], Any], world: int, *,
                    timeout: float = 60.0) -> list:
    """:func:`run_ranks` with ``fn(rank, group, new_group)``: ``new_group(
    ranks)`` makes a bare gloo subgroup of ``ranks`` over the threads'
    store (None on a rank outside it), the ``new_group`` that
    ``parallel.mesh.build_mesh`` takes; every rank calls it for the same
    subgroups in the same order, so the n-th call is one subgroup on
    every rank (its store prefix: two meshes over the same ranks make two
    groups)."""
    subgroups: list = []  # alive until every thread has ended

    def body(rank, group, store):
        calls = itertools.count()

        def new_group(ranks):
            n = next(calls)
            if rank not in ranks:
                return None
            sub = dist.ProcessGroupGloo(
                dist.PrefixStore(f"sub{n}:{ranks}", store),
                ranks.index(rank), len(ranks),
                datetime.timedelta(seconds=timeout))
            subgroups.append(sub)  # list.append is atomic under the GIL
            return sub

        return fn(rank, group, new_group)

    return run_ranks(body, world, timeout=timeout, with_store=True)


def run_ranks(fn: Callable[..., Any], world: int, *,
              timeout: float = 60.0, with_store: bool = False) -> list:
    """``[fn(rank, group) for rank in range(world)]``, each call in its own
    thread with its own gloo group of ``world`` ranks.  After every thread
    ended, the exception raised first by any rank is raised (a rank that
    fails leaves its peers waiting in a collective until the group's
    ``timeout``, and their timeouts come later).  The groups are dropped
    only after every thread ended (see the module's docstring)."""
    store = dist.HashStore()
    results: list = [None] * world
    groups: list = [None] * world
    errors: list = []

    def body(rank):
        try:
            group = groups[rank] = dist.ProcessGroupGloo(
                dist.PrefixStore("ranks", store), rank, world,
                datetime.timedelta(seconds=timeout))
            results[rank] = fn(rank, group, store) if with_store \
                else fn(rank, group)
        except BaseException as e:  # re-raised in the caller's thread
            errors.append(e)  # list.append is atomic under the GIL

    threads = [threading.Thread(target=body, args=(r,), daemon=True)
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout + 30)
    if any(t.is_alive() for t in threads):
        raise TimeoutError(f"ranks still running after {timeout + 30} s")
    if errors:
        raise errors[0]
    return results
