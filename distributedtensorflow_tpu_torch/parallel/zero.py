"""Cross-replica weight-update sharding (ZeRO stage 1).

Twin of ``distributedtensorflow_tpu/parallel/zero.py``: every parameter
is flattened, zero-padded to a multiple of the ZeRO degree N (the batch
axes' replicas, ``data`` x ``fsdp``) and viewed ``(N, ceil(size / N))``
(:func:`chunk_shape`, :func:`chunk_array`, :func:`unchunk_array`), and
each replica keeps the optimizer state of its row only.  A step
(:meth:`ZeroSharder.apply_gradients`):

- reduce-scatters the gradients' chunked views over the batch group, all
  the parameters in one flat ``(N, sum of chunks)`` buffer (the group's
  own reduce-scatter: each rank moves (N - 1)/N of the gradients where
  the all-reduce of the replicated step moves twice that);
- updates its rows of the parameters (fp32 leaf tensors the optimizer
  owns: the optimizer's moments exist for those rows only);
- all-gathers the updated rows into every replica's whole parameters.

JAX writes the reduce-scatter and the all-gather as GSPMD sharding
constraints inside the jitted step; the port calls the collectives.
Composition as in JAX: the degree counts the batch axes only, whatever
else the mesh splits.  Over a ``model`` or ``expert`` axis the chunks
are of this rank's pieces (its tensor-parallel shards, its experts and
the replicated dense layers), over ``pipe`` of its stage's parameters
(the table and ``ln_f`` arrive summed over ``pipe`` by the pipelined
loss).  Over ``seq`` a replica's ranks hold shares of one gradient: the
gradients are first all-reduced over ``seq_group``, then reduce-scattered
over the batch group, so every ``seq`` rank of a replica updates the
same row (JAX lets GSPMD sum over ``data`` x ``seq`` in one collective;
the two sums here add in another order).  Exact (up to float
reassociation) for the elementwise optimizers of :data:`ZERO_SAFE`;
clipping by the global norm sums its squares over the batch group (the
optimizer's ``split``).

Checkpoints (``checkpoint.CheckpointManager``): a ZeRO state saves each
optimizer slot gathered to its ``(N, chunk)`` view, JAX's saved layout;
a restore takes any saved layout (unchunked, or chunked at any degree)
into the target's (:func:`localize_opt_state`, through
:func:`_rechunk_opt_state`), reading the saved degree from the step's
manifest first (:func:`saved_opt_layout`, with the manager's
``item_metadata``).
"""

from __future__ import annotations

import logging
import math
from typing import Sequence

import torch

from . import collectives
from . import mesh as mesh_lib

logger = logging.getLogger("distributedtensorflow_tpu_torch")

__all__ = [
    "ZERO_SAFE",
    "ZeroSharder",
    "chunk_shape",
    "chunk_array",
    "unchunk_array",
    "saved_opt_layout",
    "restore_step_zero",
    "restore_latest_zero",
]

#: The optimizers whose update is elementwise, so a shard's update is the
#: replicated update's rows (JAX ``train/optimizers.py:69``).
ZERO_SAFE = ("sgd", "momentum", "adam", "adamw", "adagrad", "lion")


def chunk_shape(shape: Sequence[int], degree: int) -> tuple[int, int]:
    """``(degree, ceil(size / degree))``: the view every parameter shards
    into (scalars included)."""
    size = math.prod(shape) if shape else 1
    return (degree, -(-size // degree))


def chunk_array(x: torch.Tensor, degree: int) -> torch.Tensor:
    """Flattened, zero-padded to a multiple of ``degree``, viewed
    ``(degree, chunk)``."""
    d, c = chunk_shape(tuple(x.shape), degree)
    flat = x.reshape(-1)
    pad = d * c - flat.shape[0]
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(d, c)


def unchunk_array(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """The inverse of :func:`chunk_array`: the pad tail dropped, ``shape``
    restored."""
    size = math.prod(shape) if shape else 1
    return x.reshape(-1)[:size].reshape(tuple(shape))


class ZeroSharder:
    """The weight-update sharding of one mesh: ``degree`` replicas over
    the batch axes, this rank's row ``rank``, the batch group ``group``
    (its size is ``degree``; ``seq_group`` sums a replica's shares
    first).
    :meth:`shard_optimizer` builds the optimizer over this rank's rows;
    ``TrainState`` hands its updates to :meth:`apply_gradients`."""

    def __init__(self, mesh, axes: Sequence[str] | None = None):
        self.mesh = mesh
        self.axes = tuple(axes or mesh_lib.data_axes(mesh))
        if not self.axes:
            raise ValueError(f"mesh {mesh.shape} has no batch axes to shard "
                             "the weight update over")
        self.degree = math.prod(mesh.shape[a] for a in self.axes)
        if self.degree <= 1:
            raise ValueError(
                f"ZeRO degree {self.degree} (axes {self.axes} of mesh "
                f"{mesh.shape}): nothing to shard, run without --zero")
        self.rank = mesh_lib.replica_index(mesh)
        self.group = mesh.batch_group
        self.seq_group = getattr(mesh, "seq_group", collectives.SOLO)
        self._param_specs = None
        self.names: list[str] = []
        self.params: list[torch.Tensor] = []
        self.chunks: list[torch.Tensor] = []
        self._offsets: list[tuple[int, int]] = []

    def bind(self, param_specs) -> "ZeroSharder":
        """Record the parameters' specs (their tensor-parallel layout,
        which the all-gather restores: each rank gathers its own shards)."""
        self._param_specs = param_specs
        return self

    def chunk_tree(self, params: dict) -> dict:
        return {k: chunk_array(v, self.degree) for k, v in params.items()}

    def unchunk_tree(self, chunked: dict, like: dict) -> dict:
        return {k: unchunk_array(c, like[k].shape)
                for k, c in chunked.items()}

    # --- the sharded optimizer -------------------------------------------------

    def shard_optimizer(self, model: torch.nn.Module, make_optimizer):
        """``make_optimizer(named rows)`` over fp32 copies of this rank's
        row of every parameter's chunked view (the names are the
        parameters'); the sharder keeps the parameters and rows in
        order for :meth:`apply_gradients`."""
        self.names, self.params = map(list, zip(*model.named_parameters()))
        with torch.no_grad():
            self.chunks = [chunk_array(p.detach().float(), self.degree)
                           [self.rank].clone() for p in self.params]
        offset, self._offsets = 0, []
        for c in self.chunks:
            self._offsets.append((offset, c.numel()))
            offset += c.numel()
        from ..train.optimizers import Split

        opt = make_optimizer(list(zip(self.names, self.chunks)))
        # each row is a piece of its parameter: the global norm sums the
        # rows' squares over the batch group
        opt.split = Split([("zero", self.group,
                            collectives.group_rank(self.group))],
                          {id(c): ("zero",) for c in self.chunks}, {})
        return opt

    @torch.no_grad()
    def refresh_rows(self) -> None:
        """This rank's rows copied again from the parameters (after a
        restore wrote the parameters: the update starts from the rows)."""
        for c, p in zip(self.chunks, self.params):
            c.copy_(chunk_array(p.detach().float(), self.degree)[self.rank])

    def reduce_scatter_grads(self, grads: Sequence[torch.Tensor]):
        """Start the reduce-scatter of ``grads`` (by parameter, in the
        sharder's order): ``(rows, work)``, this rank's summed rows, one
        flat tensor, valid once ``work`` is waited on.  Over ``seq`` the
        replica's shares are all-reduced first (blocking)."""
        flat = torch.cat([chunk_array(g.float(), self.degree)
                          for g in grads], dim=1)
        flat = collectives.all_reduce(flat, self.seq_group)
        return collectives.reduce_scatter_async(flat, self.group)

    def split_rows(self, rows: torch.Tensor, idxs=None
                   ) -> list[torch.Tensor]:
        """``rows`` (the reduce-scatter of the parameters ``idxs``, by
        default all of them) cut into each parameter's row."""
        sizes = [n for _, n in self._offsets] if idxs is None \
            else [self._offsets[i][1] for i in idxs]
        out, o = [], 0
        for n in sizes:
            out.append(rows[o:o + n])
            o += n
        return out

    def reduce_rows(self, grads: dict) -> dict:
        """This rank's summed rows (by parameter name) of ``grads``, the
        rank's local sums: the reduce-scatter, waited on."""
        flat, work = self.reduce_scatter_grads([grads[n] for n in self.names])
        if work is not None:
            work.wait()
        return dict(zip(self.names, self.split_rows(flat)))

    @torch.no_grad()
    def apply_gradients(self, state, grads: dict, *, reduced: bool = False):
        """One sharded update: ``grads`` (by parameter name) are this
        rank's local sums, reduce-scattered here, or with ``reduced`` this
        rank's summed rows already (:meth:`reduce_rows`, or the
        overlapped sync's); the optimizer updates the rows, and the rows
        are all-gathered into the parameters."""
        if not reduced:
            grads = self.reduce_rows(grads)
        rows = [grads[n] for n in self.names]
        for c, g in zip(self.chunks, rows):
            c.grad = g
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        full = collectives.all_gather(torch.cat(self.chunks), self.group)
        full = full.reshape(self.degree, -1)
        for p, (o, n) in zip(self.params, self._offsets):
            p.copy_(unchunk_array(full[:, o:o + n], p.shape))
        state.step += 1
        return state

    # --- checkpoints --------------------------------------------------------

    def _slot_shapes(self, optimizer) -> list[tuple[int, ...]]:
        """The whole parameter shape behind each of the optimizer's
        parameters, in ``state_dict`` index order."""
        shape = {id(c): tuple(p.shape) for c, p in
                 zip(self.chunks, self.params)}
        return [shape[id(t)] for g in optimizer.param_groups
                for t in g["params"]]

    def gather_opt_state(self, sd: dict, optimizer) -> dict:
        """The optimizer's ``state_dict`` with every per-row slot gathered
        to its ``(degree, chunk)`` view (collective: every rank calls
        it)."""
        shapes = self._slot_shapes(optimizer)
        out = dict(sd, state={})
        for i, entry in sd["state"].items():
            c = chunk_shape(shapes[i], self.degree)[1]
            out["state"][i] = {
                k: collectives.all_gather(v, self.group).reshape(
                    self.degree, c)
                if torch.is_tensor(v) and tuple(v.shape) == (c,) else v
                for k, v in entry.items()}
        return out


def _rechunk_opt_state(sd: dict, shapes: Sequence[tuple[int, ...]],
                       sharder: ZeroSharder | None) -> dict:
    """A saved optimizer ``state_dict`` in the target's layout: each slot
    of parameter ``i`` (saved whole, or chunked at any degree: its flat
    values are the parameter's, then the pad) unchunked to
    ``shapes[i]``, then for a ``sharder`` chunked at its degree and cut to
    its row; scalars (a step count) as they are."""
    out = dict(sd, state={})
    for i, entry in sd["state"].items():
        shape = tuple(shapes[int(i)])
        size = math.prod(shape) if shape else 1
        new = {}
        for k, v in entry.items():
            if torch.is_tensor(v) and v.dim() > 0 and v.numel() >= size:
                v = unchunk_array(v, shape)
                if sharder is not None:
                    v = chunk_array(v, sharder.degree)[sharder.rank].clone()
            new[k] = v
        out["state"][i] = new
    return out


def localize_opt_state(sd: dict, target) -> dict:
    """A saved optimizer ``state_dict`` for ``target`` (a ``TrainState``,
    with or without a ``zero`` sharder)."""
    zero = getattr(target, "zero", None)
    if zero is not None:
        shapes = zero._slot_shapes(target.optimizer)
    else:
        shapes = [tuple(t.shape) for g in target.optimizer.param_groups
                  for t in g["params"]]
    return _rechunk_opt_state(sd, shapes, zero)


def saved_opt_layout(mgr, step: int, target) -> int | None:
    """The ZeRO degree checkpoint ``step``'s optimizer state was saved at
    (None: unchunked), from the shapes in its manifest alone
    (``mgr.item_metadata``): a slot of a parameter of another shape is
    ``(degree, chunk)``.  Raises ValueError when the step has no
    optimizer-state metadata or its shapes fit no layout."""
    meta = mgr.item_metadata(step)
    opt = meta.get("opt_state", {}).get("state") if meta else None
    if not opt:
        raise ValueError(f"checkpoint step {step} has no opt_state metadata")
    zero = getattr(target, "zero", None)
    shapes = zero._slot_shapes(target.optimizer) if zero is not None else \
        [tuple(t.shape) for g in target.optimizer.param_groups
         for t in g["params"]]
    degrees = set()
    for i, entry in opt.items():
        want = shapes[int(i)]
        for shape in entry.values():
            shape = tuple(shape)
            if len(shape) == 0 or shape == want:
                continue
            if len(shape) == 2 and shape == chunk_shape(want, shape[0]):
                degrees.add(shape[0])
            else:
                raise ValueError(f"checkpoint step {step}: slot shape "
                                 f"{shape} fits no layout of {want}")
    if len(degrees) > 1:
        raise ValueError(f"checkpoint step {step}: mixed degrees {degrees}")
    return degrees.pop() if degrees else None


def restore_step_zero(mgr, step: int, target):
    """Restore checkpoint ``step`` into ``target`` across ZeRO layouts
    (the manager converts the optimizer state, :func:`localize_opt_state`);
    ``(state, rechunked)`` with ``rechunked`` None when the saved layout
    was the target's (or the probe of it failed: then the restore is
    direct), else ``{"from": degree, "to": degree}``."""
    zero = getattr(target, "zero", None)
    to = zero.degree if zero is not None else 1
    try:
        saved = saved_opt_layout(mgr, step, target) or 1
    except ValueError as e:
        # no slots (plain SGD), no manifest, or shapes of no layout: the
        # direct restore surfaces a real mismatch itself (the reference's
        # fallback, parallel/zero.py:384-391)
        logger.warning("checkpoint step %d: ZeRO layout probe failed (%s); "
                       "attempting a direct restore", step, e)
        saved = to
    state = mgr.restore(step, target)
    if saved != to:
        logger.warning("checkpoint step %d was saved at ZeRO degree %d; "
                       "rechunked its optimizer state to degree %d", step,
                       saved, to)
        return state, {"from": saved, "to": to}
    return state, None


def restore_latest_zero(mgr, target, *, before_step: int | None = None):
    """The newest verified checkpoint restored into ``target`` across
    ZeRO layouts (``restore_latest``'s fallback over corrupt steps); the
    report (``mgr.last_restore_report``) adds ``rechunked`` when the
    layouts differed.  None when no step restores."""
    state = mgr.restore_latest(target, before_step=before_step)
    step = mgr.last_restore_report.get("restored_step")
    if state is not None and step is not None:
        zero = getattr(target, "zero", None)
        to = zero.degree if zero is not None else 1
        try:
            saved = saved_opt_layout(mgr, step, target) or 1
        except ValueError:
            saved = to
        if saved != to:
            mgr.last_restore_report["rechunked"] = {"from": saved, "to": to}
    return state
