"""Ranks as threads of one process, each with its own gloo group.

The port's counterpart of the reference's in-process multi-worker test
clusters (``distributedtensorflow_tpu/testing/multi_process_runner.py``
forks processes; threads start in milliseconds and share the test's
imports).  Every thread gets a bare ``ProcessGroupGloo`` over one shared
``HashStore``, so the port's collectives (which call the group's own
methods) run for real between the threads.  On the CPU each thread's
backward runs in the thread itself, so a collective inside a backward
(BatchNorm's statistics) meets its peers; CUDA tensors of two threads on
one card would share the card's single autograd thread and deadlock
there, so ranks on a card are processes.
"""

from __future__ import annotations

import datetime
import threading
from typing import Any, Callable

import torch.distributed as dist


def run_ranks(fn: Callable[[int, Any], Any], world: int, *,
              timeout: float = 60.0) -> list:
    """``[fn(rank, group) for rank in range(world)]``, each call in its own
    thread with its own gloo group of ``world`` ranks.  After every thread
    ended, the exception raised first by any rank is raised (a rank that
    fails leaves its peers waiting in a collective until the group's
    ``timeout``, and their timeouts come later)."""
    store = dist.HashStore()
    results: list = [None] * world
    errors: list = []

    def body(rank):
        try:
            group = dist.ProcessGroupGloo(
                dist.PrefixStore("ranks", store), rank, world,
                datetime.timedelta(seconds=timeout))
            results[rank] = fn(rank, group)
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
