"""Strategy compatibility: the reference's strategy surface on the port's
mesh.

Twin of ``distributedtensorflow_tpu/strategies.py``: each class of the
reference's ``tf.distribute`` zoo resolves to a mesh of the port's ranks
(``parallel.mesh``), because a strategy is a mesh shape.  The surface
that survives:

- ``scope()`` enters the mesh as the ambient one
  (``parallel.mesh.set_mesh``), which ``data.current_input_context``
  reads when no mesh is passed; nothing changes outside a scope;
- ``num_replicas_in_sync``: ``data`` x ``fsdp``;
- ``experimental_distribute_dataset`` / ``distribute_datasets_from_function``:
  the per-replica input split (``InputContext`` semantics);
- ``run(fn, args)`` calls ``fn`` eagerly under the scope (JAX compiles
  it over the mesh and caches the jit; eager PyTorch has nothing to
  cache);
- ``reduce(op, value, axis)`` and ``gather(value, axis)``.

The deltas from the JAX package: a JAX sharded array is the global
value, while here every rank holds its shard, the rows of the batch that
its replica holds (axis 0 split over the mesh's batch group).  So
``reduce`` and ``gather`` are collectives over the batch group, and each
gives every rank the value JAX's reduction or gather gives, as a host
(numpy) array.  ``TPUStrategy`` keeps its name for source compatibility:
it is a given ``MeshSpec`` over the world.  ``ParameterServerStrategy``
is, as in the reference, synchronous training with parameters shardable
over ``model`` (the asynchronous parameter server is
``parallel.param_server``).  Every class takes ``device`` (``cuda``
unless the caller passes ``"cpu"``; the rank's local card), and
``group``/``new_group`` (the ranks and the subgroup maker a mesh is built
over, as ``parallel.mesh.build_mesh`` takes them; default the default
process group).
"""

from __future__ import annotations

import contextlib
import logging
import math
from collections.abc import Callable, Iterator

import numpy as np
import torch

from .data.input_pipeline import (
    InputContext,
    current_input_context,
    shard_dataset,
    tfdata_iterator,
)
from .device import resolve_device
from .parallel import bootstrap
from .parallel.collectives import (
    ReduceOp,
    all_gather,
    all_reduce,
    group_size,
)
from .parallel.mesh import (
    MeshSpec,
    build_mesh,
    mirrored_mesh,
    multi_worker_mesh,
    one_device_mesh,
    set_mesh,
)

logger = logging.getLogger(__name__)

#: op -> (the local reduction, the collective across the shards)
_REDUCERS = {
    "sum": (torch.sum, ReduceOp.SUM),
    "mean": (torch.sum, ReduceOp.SUM),  # divided by the global count
    "max": (torch.amax, ReduceOp.MAX),
    "min": (torch.amin, ReduceOp.MIN),
}


class Strategy:
    """Base: a mesh of the port's ranks plus the surviving strategy
    surface."""

    def __init__(self, mesh_spec: MeshSpec | None = None, group=None, *,
                 mesh=None, device=None, new_group=None):
        self.mesh = mesh if mesh is not None else build_mesh(
            mesh_spec or MeshSpec(data=-1), group, new_group)
        self.device = bootstrap.local_device(resolve_device(device))

    # --- scope -----------------------------------------------------------

    @contextlib.contextmanager
    def scope(self):
        """The mesh as the ambient mesh inside the block."""
        with set_mesh(self.mesh):
            yield self

    # --- replica topology ------------------------------------------------

    @property
    def num_replicas_in_sync(self) -> int:
        return self.mesh.shape["data"] * self.mesh.shape["fsdp"]

    # --- input -----------------------------------------------------------

    def distribute_datasets_from_function(
            self, dataset_fn: Callable[[InputContext], Iterator], *,
            global_batch_size: int = 0) -> Iterator:
        return dataset_fn(current_input_context(global_batch_size,
                                                self.mesh))

    def experimental_distribute_dataset(self, ds) -> Iterator:
        """This replica's shard of a dataset (``.shard`` and
        ``.as_numpy_iterator``, a ``tf.data.Dataset`` among them), as
        numpy batches."""
        return tfdata_iterator(shard_dataset(
            ds, current_input_context(0, self.mesh)))

    # --- compute ---------------------------------------------------------

    def run(self, fn: Callable, args: tuple = (), kwargs: dict | None = None):
        """``fn(*args, **kwargs)``, eagerly, under :meth:`scope`."""
        with self.scope():
            return fn(*args, **(kwargs or {}))

    def _shard(self, value) -> torch.Tensor:
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value), device=self.device)
        return value.detach()

    def reduce(self, reduce_op: str, value, axis=None) -> np.ndarray:
        """Cross-replica reduce (``distribute_lib.py:1675``): "sum",
        "mean", "max" or "min" over ``axis`` (None: all axes) of the
        global array whose rows (axis 0) the batch group's ranks hold,
        ``value`` being this rank's.  A reduction over axis 0 reduces
        each shard, then the shards across the group; one that keeps
        axis 0 reduces each shard and gathers the rows.  Every rank gets
        the global result as a host array."""
        local, collective = _REDUCERS[reduce_op.lower()]  # KeyError: as JAX
        x = self._shard(value)
        if axis is None:
            axes = tuple(range(x.dim()))
        else:
            axes = tuple(a % max(x.dim(), 1) for a in (
                axis if isinstance(axis, (list, tuple)) else (axis,)))
        out = local(x, dim=axes) if axes else x
        group = self.mesh.batch_group
        count = math.prod(x.shape[a] for a in axes)
        if 0 in axes or x.dim() == 0:
            out = all_reduce(out.contiguous(), group, collective)
            count *= group_size(group)
        else:
            out = all_gather(out.contiguous(), group)
        if reduce_op.lower() == "mean":
            out = out / count
        return out.cpu().numpy()

    def gather(self, value, axis: int = 0) -> np.ndarray:
        """The shards concatenated along ``axis`` (their batch axis, the
        one the batch group splits) in replica order, as one host array on
        every rank (``distribute_lib.py:2109``)."""
        x = self._shard(value)
        return all_gather(x.contiguous(), self.mesh.batch_group,
                          gather_axis=axis).cpu().numpy()


class OneDeviceStrategy(Strategy):
    """``one_device_strategy.py:39``: a mesh of one on this process's
    device (``mesh.one_device_mesh``)."""

    def __init__(self, device=None):
        super().__init__(mesh=one_device_mesh(), device=device)


class MirroredStrategy(Strategy):
    """``mirrored_strategy.py:200`` (in-host sync DP): ``data`` over the
    ranks of this host, one process a device (``mesh.mirrored_mesh``:
    ``LOCAL_WORLD_SIZE`` ranks)."""

    def __init__(self, group=None, *, device=None, new_group=None):
        super().__init__(mesh=mirrored_mesh(group, new_group), device=device)


class MultiWorkerMirroredStrategy(Strategy):
    """``collective_all_reduce_strategy.py:57`` (multi-host sync DP): the
    default process group started over ``cluster`` (default: the resolved
    one) with ``backend``, as ``train_torch.py --dist-backend`` starts it
    (this rank's card made current first), then ``data=-1`` over the
    world.  A given ``group`` is already up: nothing starts."""

    def __init__(self, cluster=None, *, backend: str = "nccl", group=None,
                 device=None, new_group=None):
        device = bootstrap.local_device(resolve_device(device))
        if group is None:
            if device.type == "cuda":
                torch.cuda.set_device(device)
            bootstrap.initialize(cluster, backend=backend)
        super().__init__(mesh=multi_worker_mesh(group, new_group),
                         device=device)


class ParameterServerStrategy(Strategy):
    """``parameter_server_strategy_v2.py:77``: synchronous training with
    parameters shardable over ``model`` (the reference's semantic delta;
    the asynchronous parameter server is ``parallel.param_server``)."""

    def __init__(self, model_axis_size: int = -1, group=None, *,
                 device=None, new_group=None):
        n = group_size(group)
        if model_axis_size == -1:
            # the largest divisor of n at or below n//2 (1 when n is 1 or
            # prime)
            model_axis_size = next(
                (d for d in range(n // 2, 0, -1) if n % d == 0), 1)
        super().__init__(MeshSpec(data=-1, model=model_axis_size), group,
                         device=device, new_group=new_group)
        logger.info(
            "ParameterServerStrategy maps to sync sharded-variable training "
            "(model axis = %d); parallel.param_server runs the async PS",
            model_axis_size)


class TPUStrategy(Strategy):
    """``tpu_strategy.py:243``, the name kept for source compatibility:
    ``mesh_spec`` (default ``data=-1``) over the world's ranks."""

    def __init__(self, mesh_spec: MeshSpec | None = None, group=None, *,
                 device=None, new_group=None):
        super().__init__(mesh_spec or MeshSpec(data=-1), group,
                         device=device, new_group=new_group)
