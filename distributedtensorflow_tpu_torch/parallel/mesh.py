"""The device mesh of the port: axis sizes, this rank's place, the batch
group.

Twin of ``distributedtensorflow_tpu/parallel/mesh.py``: the canonical
axes, :class:`MeshSpec` with ``resolve`` (``:62-101``), :func:`build_mesh`
(``:104``), :func:`data_axes` and :func:`replica_count` (``:251-258``).
JAX's mesh is an array of devices that one SPMD program spans; here every
rank is a process with one device, and the mesh is a small object: the
size of each axis, this rank's coordinate on each, and one process group
per axis kind: ``group`` over the batch axes (``data`` x ``fsdp``), over
which the gradients of replicated parameters are summed, and
``model_group`` over ``model``, the tensor-parallel ranks that hold one
replica's shards.  ``fsdp`` is a batch axis, as in JAX.  ``pipe``,
``seq`` and ``expert`` larger than 1 raise "not ported".
"""

from __future__ import annotations

import dataclasses
import math

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

#: The axes the port runs larger than 1.
PORTED_AXES: tuple[str, ...] = (AXIS_DATA, AXIS_FSDP, AXIS_MODEL)


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
    this rank's index on it), ``group``, the process group of the batch
    axes, and ``model_group``, that of the ``model`` axis (None for a
    world of one process without a group, :data:`~.collectives.SOLO`
    for an axis of size 1 in a larger world: every collective over it is
    the identity, as a size-1 axis is in JAX)."""

    shape: dict
    coords: dict
    group: object = None
    model_group: object = SOLO

    @property
    def axis_names(self) -> tuple[str, ...]:
        return CANONICAL_AXES


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
    of one with no group).  Raises for an axis the port has not ported.

    With ``model`` > 1 the ranks split into batch groups (the ranks of
    one ``model`` coordinate) and model groups (the ranks of one replica,
    consecutive in the mesh-major order), each made by ``new_group(ranks)``
    (default ``torch.distributed.new_group``; the thread ranks of
    ``testing.ranks`` pass bare gloo groups), called on every rank for
    every subgroup in one order; a subgroup that spans the world is
    ``group`` itself."""
    group = resolve_group(group)
    world = 1 if group is None else group.size()
    rank = 0 if group is None else group.rank()
    sizes = dict(zip(CANONICAL_AXES, spec.resolve(world)))
    big = [a for a, s in sizes.items() if s > 1 and a not in PORTED_AXES]
    if big:
        raise NotImplementedError(
            f"mesh axes {big} are not ported (sizes {sizes}): "
            f"{', '.join(a for a in CANONICAL_AXES if a not in PORTED_AXES)}"
            " run at size 1 until the pipeline, sequence and expert "
            "parallelism of ROADMAP.md item 7")
    # mesh-major: the data axis is outermost, so a rank's data coordinate
    # is its rank over the product of the inner axes
    coords, rest = {}, rank
    for axis in reversed(CANONICAL_AXES):
        coords[axis] = rest % sizes[axis]
        rest //= sizes[axis]
    coords = {a: coords[a] for a in CANONICAL_AXES}
    tp = sizes[AXIS_MODEL]
    if tp == 1:
        return Mesh(shape=sizes, coords=coords, group=group)
    replicas = world // tp
    new_group = new_group or _new_group
    subgroups = ([[b * tp + m for b in range(replicas)] for m in range(tp)]
                 + [[b * tp + m for m in range(tp)]
                    for b in range(replicas)])
    made = []
    for ranks in subgroups:
        if len(ranks) == 1:
            made.append(SOLO)
        elif len(ranks) == world:
            made.append(group)
        else:
            made.append(new_group(ranks))
    batch = made[rank % tp]
    model = made[tp + rank // tp]
    return Mesh(shape=sizes, coords=coords, group=batch, model_group=model)


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
