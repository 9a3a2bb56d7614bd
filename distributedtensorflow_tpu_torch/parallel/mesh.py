"""The device mesh of the port: axis sizes, this rank's place, the batch
group.

Twin of ``distributedtensorflow_tpu/parallel/mesh.py``: the canonical
axes, :class:`MeshSpec` with ``resolve`` (``:62-101``), :func:`build_mesh`
(``:104``), :func:`data_axes` and :func:`replica_count` (``:251-258``).
JAX's mesh is an array of devices that one SPMD program spans; here every
rank is a process with one device, and the mesh is a small object: the
size of each axis, this rank's coordinate on each, and one process group
per kind of collective:

- ``group`` over ``data`` x ``fsdp`` x ``seq``: the ranks whose losses
  are shares of one global mean and over which the gradients of
  replicated parameters are summed.  JAX's ``BATCH_AXES`` are ``data``
  and ``fsdp``, and GSPMD sums the gradients of a sequence-sharded
  program over ``seq`` by itself; here each ``seq`` rank holds its own
  slice of the sequence through the whole block stack
  (``models.gpt``), so its loss is a share too.
- ``batch_group`` over ``data`` x ``fsdp`` alone: the replicas, which
  exchange rows of a batch (``data.exchange_rows``); ``group`` itself
  while ``seq`` is 1.
- ``seq_group`` over ``seq`` (ring and Ulysses attention,
  ``parallel.ring_attention``), ``expert_group`` over ``expert`` (the
  all-to-all dispatch of ``parallel.moe``) and ``model_group`` over
  ``model``, the tensor-parallel ranks that hold one replica's shards.
- ``pipe_group`` over ``pipe``: the stages of one pipeline, whose group
  rank is the stage (``parallel.pipeline``'s handoffs go to the group
  rank after and come from the one before, the last stage's to the
  first, as JAX's ``perm_fwd`` ring wraps); ``pipe_prev`` and
  ``pipe_next`` are their global ranks.

``fsdp`` is a batch axis, as in JAX; ``expert`` is one only inside the
MoE region, whose dense layers stay replicated over it.  ``pipe`` is no
batch axis: a stage's blocks see every row of its replica, and their
gradients are summed over ``data`` and ``fsdp`` only
(``models.gpt_pipeline`` sums the replicated embedding and final
LayerNorm over ``pipe`` itself).

The strategy presets (``:232-250`` of the reference) are
:func:`one_device_mesh`, :func:`mirrored_mesh` and
:func:`multi_worker_mesh`; :func:`set_mesh` enters a mesh as the ambient
one (``jax.sharding.set_mesh``: a ``Strategy.scope()``), which
:func:`current_mesh` reads (``data.current_input_context`` when no mesh
is passed).  The ambient mesh is a context variable: each thread starts
without one.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import os

import torch.distributed as dist

from .collectives import SOLO, resolve_group

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_PIPE = "pipe"
AXIS_SEQ = "seq"
AXIS_EXPERT = "expert"
AXIS_MODEL = "model"

#: Mesh-major order, ``data`` outermost.
CANONICAL_AXES: tuple[str, ...] = (
    AXIS_DATA, AXIS_FSDP, AXIS_PIPE, AXIS_SEQ, AXIS_EXPERT, AXIS_MODEL)

#: Axes over which gradients of replicated parameters are summed.
BATCH_AXES: tuple[str, ...] = (AXIS_DATA, AXIS_FSDP)

#: The axes of each of a :class:`Mesh`'s groups: the ranks of a group
#: differ on these axes and share their coordinates on all the others.
GROUP_AXES: dict[str, tuple[str, ...]] = {
    "group": (AXIS_DATA, AXIS_FSDP, AXIS_SEQ),
    "batch_group": BATCH_AXES,
    "seq_group": (AXIS_SEQ,),
    "expert_group": (AXIS_EXPERT,),
    "model_group": (AXIS_MODEL,),
    "pipe_group": (AXIS_PIPE,),
}


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Mesh shape over the canonical axes; one axis may be ``-1``, all the
    ranks the others leave."""

    data: int = -1
    fsdp: int = 1
    pipe: int = 1
    seq: int = 1
    expert: int = 1
    model: int = 1

    def sizes(self) -> tuple[int, ...]:
        return (self.data, self.fsdp, self.pipe, self.seq, self.expert,
                self.model)

    def resolve(self, n_devices: int) -> tuple[int, ...]:
        """Concrete per-axis sizes for ``n_devices``, expanding a single
        -1."""
        sizes = list(self.sizes())
        wild = [i for i, s in enumerate(sizes) if s == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one axis may be -1, got spec {self}")
        fixed = math.prod(s for s in sizes if s != -1)
        if wild:
            if n_devices % fixed:
                raise ValueError(f"{n_devices} devices not divisible by "
                                 f"fixed axes product {fixed}")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh spec {self} needs {fixed} devices, have {n_devices}")
        return tuple(sizes)

    def build(self, group=None) -> "Mesh":
        return build_mesh(self, group)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``shape`` (axis -> size, every canonical axis), ``coords`` (axis ->
    this rank's index on it) and the process groups of
    :data:`GROUP_AXES` (see the module docstring): None for a world of
    one process without a group, :data:`~.collectives.SOLO` for a group
    of one rank in a larger world (every collective over it is the
    identity, as over a size-1 axis in JAX)."""

    shape: dict
    coords: dict
    group: object = None
    model_group: object = SOLO
    batch_group: object = None
    seq_group: object = SOLO
    expert_group: object = SOLO
    pipe_group: object = SOLO
    #: the global ranks of the previous and the next stage on ``pipe``
    #: (this rank's own for a ``pipe`` of 1)
    pipe_prev: int = 0
    pipe_next: int = 0
    #: every rank of the mesh (the group it was built over): the ranks
    #: that agree on a checkpoint save and a preemption
    world: object = None

    @property
    def axis_names(self) -> tuple[str, ...]:
        return CANONICAL_AXES

    @property
    def size(self) -> int:
        """The number of ranks the mesh spans."""
        return math.prod(self.shape.values())


def parse_mesh(text: str | None) -> MeshSpec | None:
    """``"data=2"`` -> ``MeshSpec(data=2)`` (``train.py:40``'s parse);
    None or "" -> None."""
    if not text:
        return None
    kw = {}
    for part in text.split(","):
        k, v = part.split("=")
        kw[k.strip()] = int(v)
    return MeshSpec(**kw)


def _new_group(ranks: list[int]):
    """``torch.distributed.new_group`` of ``ranks`` (every rank calls it
    for every subgroup, in the same order)."""
    return dist.new_group(ranks)


def build_mesh(spec: MeshSpec, group=None, new_group=None) -> Mesh:
    """The mesh of ``spec`` over ``group``'s ranks (default: the default
    process group when ``torch.distributed`` is initialised, else a world
    of one with no group).

    The ranks split into the groups of :data:`GROUP_AXES` (for each kind,
    the ranks that share their coordinates on the other axes, in rank
    order), each made by ``new_group(ranks)`` (default
    ``torch.distributed.new_group``; the thread ranks of
    ``testing.ranks`` pass bare gloo groups), called on every rank for
    every subgroup of more than one rank and less than the world, kind
    after kind in :data:`GROUP_AXES`'s order, in one order on every rank
    (two kinds over the same ranks share one group); a subgroup that
    spans the world is ``group`` itself and one of one rank
    :data:`~.collectives.SOLO`."""
    group = resolve_group(group)
    world = 1 if group is None else group.size()
    rank = 0 if group is None else group.rank()
    sizes = dict(zip(CANONICAL_AXES, spec.resolve(world)))
    # mesh-major: the data axis is outermost, so a rank's data coordinate
    # is its rank over the product of the inner axes
    coords = _coords_of(rank, sizes)
    coords = {a: coords[a] for a in CANONICAL_AXES}
    if world == 1:
        return Mesh(shape=sizes, coords=coords, group=group,
                    batch_group=group, world=group)
    n_pipe = sizes[AXIS_PIPE]
    neighbours = {
        key: _rank_of({**coords, AXIS_PIPE: (coords[AXIS_PIPE] + step)
                       % n_pipe}, sizes)
        for key, step in (("pipe_prev", -1), ("pipe_next", 1))}
    new_group = new_group or _new_group
    all_coords = [_coords_of(r, sizes) for r in range(world)]
    groups, made_for = {}, {}
    for kind, axes in GROUP_AXES.items():
        # the ranks that share this rank's coordinates off ``axes``, and
        # every other such set, each made on every rank in one order
        parts: dict[tuple, list[int]] = {}
        for r, c in enumerate(all_coords):
            key = tuple(c[a] for a in CANONICAL_AXES if a not in axes)
            parts.setdefault(key, []).append(r)
        for ranks in parts.values():
            key = tuple(ranks)
            if key not in made_for:  # kinds that span the same ranks share
                made_for[key] = (SOLO if len(ranks) == 1 else
                                 group if len(ranks) == world else
                                 new_group(ranks))
            if rank in ranks:
                groups[kind] = made_for[key]
    return Mesh(shape=sizes, coords=coords, **groups, **neighbours,
                world=group)


def _coords_of(rank: int, sizes: dict) -> dict:
    """Rank ``rank``'s coordinate on each axis, mesh-major (``data``
    outermost)."""
    coords, rest = {}, rank
    for axis in reversed(CANONICAL_AXES):
        coords[axis] = rest % sizes[axis]
        rest //= sizes[axis]
    return coords


def _rank_of(coords: dict, sizes: dict) -> int:
    """The rank at ``coords``, mesh-major (the inverse of
    :func:`_coords_of`)."""
    rank = 0
    for axis in CANONICAL_AXES:
        rank = rank * sizes[axis] + coords[axis]
    return rank


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """The batch axes present in ``mesh``."""
    return tuple(a for a in BATCH_AXES if a in mesh.axis_names)


def replica_count(mesh: Mesh) -> int:
    """Number of data-parallel replicas (product of batch-axis sizes)."""
    return math.prod(mesh.shape[a] for a in data_axes(mesh))


def replica_index(mesh: Mesh) -> int:
    """This rank's index among the replicas (mesh-major over the batch
    axes): the slice of the global batch it holds."""
    idx = 0
    for a in data_axes(mesh):
        idx = idx * mesh.shape[a] + mesh.coords[a]
    return idx


# --- the strategy presets: each reference strategy is a mesh shape. ---


def one_device_mesh() -> Mesh:
    """``OneDeviceStrategy``: a mesh of this rank alone (every axis 1),
    whatever process group is up."""
    return build_mesh(MeshSpec(data=1), SOLO)


def mirrored_mesh(group=None, new_group=None) -> Mesh:
    """``MirroredStrategy`` (in-host sync DP): ``data`` over the ranks of
    this host, one process a device.  ``LOCAL_WORLD_SIZE`` (torchrun's)
    ranks a host, in rank order; the whole of ``group`` without it.  With
    several hosts every rank makes every host's group, in host order
    (``new_group``: as :func:`build_mesh`'s)."""
    group = resolve_group(group)
    world = 1 if group is None else group.size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if local >= world:
        return build_mesh(MeshSpec(data=-1), group, new_group)
    if world % local:
        raise ValueError(f"LOCAL_WORLD_SIZE={local} does not divide the "
                         f"world of {world} ranks")
    new_group = new_group or _new_group
    host = group.rank() // local
    hosts = [new_group(list(range(h * local, (h + 1) * local)))
             for h in range(world // local)]
    return build_mesh(MeshSpec(data=-1), hosts[host], new_group)


def multi_worker_mesh(group=None, new_group=None) -> Mesh:
    """``MultiWorkerMirroredStrategy``: ``data`` over every rank of
    ``group`` (default: the default process group)."""
    return build_mesh(MeshSpec(data=-1), group, new_group)


_AMBIENT: contextvars.ContextVar = contextvars.ContextVar(
    "ambient_mesh", default=None)


@contextlib.contextmanager
def set_mesh(mesh: Mesh):
    """``mesh`` as the ambient mesh inside the block (the previous one,
    or none, after it)."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def current_mesh() -> Mesh | None:
    """The ambient mesh of :func:`set_mesh`, or None outside one."""
    return _AMBIENT.get()
