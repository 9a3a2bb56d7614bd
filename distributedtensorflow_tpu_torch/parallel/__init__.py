"""Parallelism of the port: the mesh and its groups (``mesh``), the
cluster bootstrap (``bootstrap``), the collectives (``collectives``), the
layout rules and tensor parallelism (``sharding``), ZeRO (``zero``), the
overlapped gradient sync (``overlap``), the MoE layer and its
expert-parallel region (``moe``), sequence parallelism
(``ring_attention``), the pipeline schedules (``pipeline``), the closure
dispatcher (``coordinator``), the async parameter server
(``param_server``) and the MPMD stage-per-process pipeline
(``pipeline_mpmd``).

The dispatcher's and the parameter server's names are exported lazily:
both use ``obs``, which imports ``parallel.bootstrap`` while it loads."""

import importlib

from .moe import ROUTERS, local_moe, top1_route, top2_route  # noqa: F401

_LAZY = {
    "coordinator": ("ClosureAborted", "Coordinator", "PerWorker",
                    "RemoteValue", "WorkerUnavailableError"),
    "param_server": ("AsyncPSClient", "AsyncPSTrainer", "PlacementPlan",
                     "PSServer", "PSUnavailableError",
                     "build_cluster_pieces", "partition_params",
                     "reassemble", "split_like", "worker_loop"),
}
_LAZY_NAMES = {name: mod for mod, names in _LAZY.items() for name in names}


def __getattr__(name):
    mod = _LAZY_NAMES.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{mod}", __name__), name)


def __dir__():
    return sorted([*globals(), *_LAZY_NAMES])
