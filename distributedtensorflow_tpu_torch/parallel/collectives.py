"""Collectives of the port over ``torch.distributed`` process groups.

Twin of ``distributedtensorflow_tpu/parallel/collectives.py``:
:class:`ReduceOp`, :class:`Options`, :func:`all_reduce`,
:func:`tree_all_reduce`, :func:`all_gather`, :func:`reduce_scatter`,
:func:`broadcast`, :func:`pack_by_size`, :func:`packed_all_reduce`
(``:99-212,273-388``), and the ``lax`` collectives of the ``seq`` and
``expert`` regions: :func:`all_to_all` (the tiled ``lax.all_to_all``)
and :func:`ring_shift` (``lax.ppermute`` with ``i -> i + 1``).  JAX names a mesh axis inside one SPMD program;
here each function takes the process group of the ranks it spans: a
``ProcessGroup``, a :class:`~.mesh.Mesh` (its batch group), or None (the
default group when ``torch.distributed`` is initialised, else a world of
one, where every collective is the identity).  Each call runs the group's
own method (``group.allreduce([t], opts).wait()`` ...), so a bare
``ProcessGroupGloo`` made per thread serves as well as the default
group.

:func:`all_reduce` (SUM and MEAN) and :func:`all_gather` are
differentiable: the backward of a sum over ranks is the sum of the
incoming gradients over ranks (every rank's loss depends on the sum), and
the backward of a gather is that sum's own slice.  Tensor parallelism
takes Megatron's pair: :func:`copy_to_group` (the identity, its gradient
summed over the ranks) and :func:`reduce_from_group` (the sum, its
gradient whole on each rank), since every rank of a ``model`` group
computes the whole loss.  :func:`reduce_scatter` is the group's own
(ZeRO's gradients), with :func:`reduce_scatter_async` and
:func:`all_reduce_async` for the overlapped gradient sync.  Gloo takes
CUDA tensors for all-reduce and broadcast only, so a gather or a
reduce-scatter of a CUDA tensor over gloo goes through the host, and so
do :func:`all_to_all` and :func:`ring_shift` (gloo's send and receive
read the data pointer as host memory).  Both are differentiable: the
backward of an all-to-all is the inverse all-to-all and that of a shift
the reverse shift.  :func:`exchange` is a pipeline's tick: each stage's
activation to the next stage and its cotangent to the previous one, in
lock step.  :func:`split_to_group` and :func:`gather_from_group`
are the pair of a region whose ranks all compute the same loss (the
expert-parallel MoE layer): a rank's slice, whose gradient gathers the
slices, and the gather, whose gradient is the rank's slice.  The
``gspmd_*`` constraints have no counterpart: every rank runs its own
program on its shards.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Sequence

import torch
import torch.distributed as dist

#: The engine's pack size for the gradient all-reduce (DDP's default
#: bucket: a few large collectives, not one per parameter).
DEFAULT_BYTES_PER_PACK = 25 * 2**20


class ReduceOp(enum.Enum):
    """Reduction kinds (``tf.distribute.ReduceOp`` + min/max)."""

    SUM = "sum"
    MEAN = "mean"
    MAX = "max"
    MIN = "min"


@dataclasses.dataclass(frozen=True)
class Options:
    """``bytes_per_pack`` feeds :func:`packed_all_reduce` (0 = one
    collective per tensor).  JAX's ``timeout_seconds`` and
    ``implementation`` are left out: a hang surfaces through the group's
    own timeout, and the backend is chosen when the group starts."""

    bytes_per_pack: int = 0


class _Solo:
    """A group of this rank alone inside a larger world (a mesh axis of
    size 1): every collective over it is the identity."""

    def __repr__(self):
        return "SOLO"


#: The group of one rank: :func:`resolve_group` maps it to None.
SOLO = _Solo()


def resolve_group(group=None):
    """The process group behind ``group`` (a group, a mesh or None), or
    None for a world of one without a group (or :data:`SOLO`)."""
    group = getattr(group, "group", group)
    if group is SOLO:
        return None
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    return group


def group_size(group=None) -> int:
    group = resolve_group(group)
    return 1 if group is None else group.size()


def group_rank(group=None) -> int:
    group = resolve_group(group)
    return 0 if group is None else group.rank()


_C10D_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MEAN: dist.ReduceOp.SUM,
             ReduceOp.MAX: dist.ReduceOp.MAX, ReduceOp.MIN: dist.ReduceOp.MIN}


def _all_reduce_(t: torch.Tensor, group, op: ReduceOp) -> torch.Tensor:
    """``t`` (contiguous) reduced in place over ``group``; MEAN is the sum
    over the group's size (gloo has no average)."""
    opts = dist.AllreduceOptions()
    opts.reduceOp = _C10D_OPS[op]
    group.allreduce([t], opts).wait()
    if op is ReduceOp.MEAN:
        t.div_(group.size())
    return t


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, op):
        ctx.group, ctx.op = group, op
        return _all_reduce_(x.contiguous().clone(), group, op)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.contiguous().clone(), ctx.group, ctx.op), \
            None, None


def all_reduce(x: torch.Tensor, group=None,
               op: ReduceOp = ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over the ranks of ``group`` (a new tensor; ``x``
    itself for a world of one).  Differentiable for SUM and MEAN."""
    group = resolve_group(group)
    if group is None:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        if op not in (ReduceOp.SUM, ReduceOp.MEAN):
            raise NotImplementedError(f"no gradient for all_reduce {op}")
        return _AllReduce.apply(x, group, op)
    return _all_reduce_(x.detach().contiguous().clone(), group, op)


def tree_all_reduce(tree, group=None, op: ReduceOp = ReduceOp.SUM):
    """Every tensor of a list, tuple or dict all-reduced, one collective
    each."""
    if isinstance(tree, dict):
        return {k: all_reduce(v, group, op) for k, v in tree.items()}
    return type(tree)(all_reduce(v, group, op) for v in tree)


def _gather_list(x: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``x`` (same shape on each), in rank order."""
    host = x.is_cuda and group.name() == "gloo"
    src = (x.cpu() if host else x).contiguous()
    outs = [torch.empty_like(src) for _ in range(group.size())]
    group.allgather([outs], [src]).wait()
    return [o.to(x.device) for o in outs] if host else outs


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return torch.cat(_gather_list(x.detach(), group), axis)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce_(g.contiguous().clone(), ctx.group, ReduceOp.SUM)
        return g.chunk(ctx.group.size(), ctx.axis)[ctx.group.rank()], \
            None, None


def all_gather(x: torch.Tensor, group=None, *, gather_axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Every rank's ``x`` in rank order: concatenated along
    ``gather_axis`` (``tiled``) or stacked on a new axis there.
    Differentiable."""
    group = resolve_group(group)
    if not tiled:
        x = x.unsqueeze(gather_axis)
    if group is None:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _AllGather.apply(x, group, gather_axis)
    return torch.cat(_gather_list(x, group), gather_axis)


def reduce_scatter_async(x: torch.Tensor, group=None):
    """Start the reduce-scatter of ``x`` (N, ...) over the N ranks of
    ``group``: ``(out, work)`` with ``out`` this rank's row of the sum
    over the ranks (rank r gets row r) once ``work.wait()`` returned
    (``work`` is None for a world of one, and for CUDA tensors over
    gloo, which moves them through the host and has finished).  The
    group's own reduce-scatter, so each rank sends and receives
    (N - 1)/N of ``x`` where an all-reduce moves twice that (ZeRO's
    halved traffic)."""
    group = resolve_group(group)
    if group is None:
        return x[0], None
    n = group.size()
    if x.shape[0] != n:
        raise ValueError(f"reduce-scatter of {tuple(x.shape)} over {n} "
                         f"ranks: dim 0 must be the rank count")
    host = x.is_cuda and group.name() == "gloo"
    src = (x.detach().cpu() if host else x.detach()).contiguous()
    out = torch.empty_like(src[0])
    opts = dist.ReduceScatterOptions()
    opts.reduceOp = dist.ReduceOp.SUM
    work = group.reduce_scatter([out], [list(src.unbind(0))], opts)
    if host:
        work.wait()
        return out.to(x.device), None
    return out, work


def reduce_scatter(x: torch.Tensor, group=None, *,
                   scatter_axis: int = 0) -> torch.Tensor:
    """This rank's 1/N slice along ``scatter_axis`` of the sum over
    ranks, through the group's own reduce-scatter
    (:func:`reduce_scatter_async`); the axis must divide evenly."""
    group = resolve_group(group)
    if group is None:
        return x
    n = group.size()
    if x.shape[scatter_axis] % n:
        raise ValueError(f"reduce-scatter axis {scatter_axis} of "
                         f"{tuple(x.shape)} does not divide over {n} ranks")
    parts = torch.stack(x.chunk(n, scatter_axis))
    out, work = reduce_scatter_async(parts, group)
    if work is not None:
        work.wait()
    return out


def all_reduce_async(t: torch.Tensor, group=None):
    """Start the SUM all-reduce of ``t`` (contiguous) in place over
    ``group``; the group's work handle (None for a world of one), to be
    waited on before ``t`` is read."""
    group = resolve_group(group)
    if group is None:
        return None
    opts = dist.AllreduceOptions()
    opts.reduceOp = dist.ReduceOp.SUM
    return group.allreduce([t], opts)


class _CopyToGroup(torch.autograd.Function):
    """Megatron's ``f``: the identity forward, the gradient summed over
    the group's ranks in the backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.contiguous().clone(), ctx.group,
                            ReduceOp.SUM), None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's ``g``: the sum over the group's ranks forward, the
    identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_(x.contiguous().clone(), group, ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` where every rank of a tensor-parallel ``group`` computes the
    same loss from it: the identity, whose backward sums the ranks'
    partial gradients (the input of a column-parallel layer)."""
    group = resolve_group(group)
    if group is None or not (x.requires_grad and torch.is_grad_enabled()):
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` (a row-parallel layer's
    output), whose gradient each rank takes whole: every rank of a
    tensor-parallel group computes the same loss from the sum."""
    group = resolve_group(group)
    if group is None:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _ReduceFromGroup.apply(x, group)
    return _all_reduce_(x.detach().contiguous().clone(), group, ReduceOp.SUM)


def _via_host(x: torch.Tensor, group) -> bool:
    """Whether ``x`` goes through the host for ``group``: a CUDA tensor
    over gloo, whose point-to-point and all-to-all read host memory."""
    return x.is_cuda and group.name() == "gloo"


def _all_to_all(x: torch.Tensor, group, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    """The tiled all-to-all over ``group`` (no autograd): ``x`` cut into
    N chunks along ``split_axis``, chunk j to rank j, the chunks received
    concatenated along ``concat_axis`` in rank order."""
    n = group.size()
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all split axis {split_axis} of "
                         f"{tuple(x.shape)} does not divide over {n} ranks")
    parts = torch.stack(x.chunk(n, split_axis))  # (N, ...) contiguous
    host = _via_host(parts, group)
    src = parts.cpu() if host else parts
    out = torch.empty_like(src)
    group.alltoall_base(out, src, [], [], dist.AllToAllOptions()).wait()
    if host:
        out = out.to(x.device)
    return torch.cat(out.unbind(0), concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return _all_to_all(x.detach(), group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return _all_to_all(g.contiguous(), ctx.group, concat_axis,
                           split_axis), None, None, None


def all_to_all(x: torch.Tensor, group=None, *, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``
    over the ranks of ``group``: ``x`` for a world of one.
    Differentiable (the backward is the inverse all-to-all)."""
    group = resolve_group(group)
    if group is None:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _AllToAll.apply(x, group, split_axis, concat_axis)
    return _all_to_all(x, group, split_axis, concat_axis)


class Shift:
    """A ring shift in flight (:func:`start_ring_shift`): ``wait()``
    returns the tensors received from the previous rank, on the devices
    they were sent from."""

    def __init__(self, received, works, devices):
        self._received, self._works, self._devices = received, works, devices

    def wait(self) -> list[torch.Tensor]:
        for w in self._works:
            w.wait()
        return [r.to(d) if r.device != d else r
                for r, d in zip(self._received, self._devices)]


def start_ring_shift(tensors, group, *, reverse: bool = False,
                     tag: int = 0) -> Shift:
    """Start sending each of ``tensors`` to the next rank of ``group``
    (the previous one with ``reverse``) and receiving the previous rank's
    (no autograd); the caller computes meanwhile and then waits.  Gloo
    runs each transfer through the group's own send and receive (CUDA
    tensors through the host); another backend batches them with
    ``torch.distributed.batch_isend_irecv``, so that NCCL groups the
    sends and receives of the ring and none waits for its peer's.
    Gloo's transfers carry the tags ``tag``, ``tag + 1``, ...: two
    shifts in flight at once take tags that do not overlap."""
    n, r = group.size(), group.rank()
    dst, src = ((r - 1) % n, (r + 1) % n) if reverse \
        else ((r + 1) % n, (r - 1) % n)
    devices = [t.device for t in tensors]
    if group.name() == "gloo":
        sends = [(t.cpu() if t.is_cuda else t).contiguous() for t in tensors]
        received = [torch.empty_like(t) for t in sends]
        works = []
        for i, (s, buf) in enumerate(zip(sends, received)):
            works.append(group.send([s], dst, tag + i))
            works.append(group.recv([buf], src, tag + i))
        return Shift(received, works, devices)
    sends = [t.contiguous() for t in tensors]
    received = [torch.empty_like(t) for t in sends]
    ops = []
    for s, buf in zip(sends, received):
        ops.append(dist.P2POp(dist.isend, s, group=group, group_peer=dst))
        ops.append(dist.P2POp(dist.irecv, buf, group=group, group_peer=src))
    return Shift(received, dist.batch_isend_irecv(ops), devices)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return start_ring_shift([x.detach()], group).wait()[0]

    @staticmethod
    def backward(ctx, g):
        return start_ring_shift([g], ctx.group, reverse=True).wait()[0], None


def ring_shift(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.ppermute(x, axis, [(i, (i + 1) % n)])``: the previous rank's
    ``x`` on every rank of ``group`` (``x`` for a world of one).
    Differentiable (the backward shifts the gradient the other way)."""
    group = resolve_group(group)
    if group is None:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _RingShift.apply(x, group)
    return start_ring_shift([x], group).wait()[0]


def exchange(to_next: torch.Tensor | None, to_prev: torch.Tensor | None,
             group, *, next_wire=None, prev_wire=None):
    """One tick of a pipeline's handoffs over the stages of ``group``
    (a ``pipe`` group: the group rank is the stage): ``to_next`` goes to
    the next stage and ``to_prev`` to the previous one, the ring wrapping
    from the last stage to the first, and ``(from_prev, from_next)``
    come back: the previous stage's ``to_next`` and the next stage's
    ``to_prev`` (None for a direction no rank sends).  Every stage must
    call it at every tick with the same directions, idle ticks included:
    the exchange is in lock step and cannot deadlock.  ``next_wire`` and
    ``prev_wire`` are the twins of ``_wire_ppermute``
    (``parallel/pipeline.py:54-61``): the dtype of that payload on the
    wire, cast back to the sent dtype on receipt (None: as it is).  On
    NCCL the sends and receives are one ``batch_isend_irecv``; on gloo
    the group's own send and receive, through the host for CUDA
    tensors.  No autograd.  For a group of one the ring maps the stage to
    itself."""
    group = resolve_group(group)
    sends = ((to_next, next_wire, 1), (to_prev, prev_wire, -1))
    if group is None or group.size() == 1:
        return tuple(None if t is None else
                     t if wire is None else t.to(wire).to(t.dtype)
                     for t, wire, _ in sends)
    n, r = group.size(), group.rank()
    gloo = group.name() == "gloo"
    ops, works, received = [], [], []
    for tag, (t, wire, step) in enumerate(sends):
        if t is None:
            received.append(None)
            continue
        payload = (t if wire is None else t.to(wire)).contiguous()
        if gloo and payload.is_cuda:
            payload = payload.cpu()
        buf = torch.empty_like(payload)
        dst, src = (r + step) % n, (r - step) % n
        if gloo:
            works.append(group.send([payload], dst, tag))
            works.append(group.recv([buf], src, tag))
        else:
            ops.append(dist.P2POp(dist.isend, payload, group=group,
                                  group_peer=dst))
            ops.append(dist.P2POp(dist.irecv, buf, group=group,
                                  group_peer=src))
        received.append((buf, t))
    if ops:
        works = dist.batch_isend_irecv(ops)
    for w in works:
        w.wait()
    return tuple(None if got is None else
                 got[0].to(device=got[1].device, dtype=got[1].dtype)
                 for got in received)


class _SplitToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return x.chunk(group.size(), axis)[group.rank()].contiguous()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(_gather_list(g.contiguous(), ctx.group),
                         ctx.axis), None, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return torch.cat(_gather_list(x.detach(), group), axis)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.group.size(), ctx.axis)[ctx.group.rank()] \
            .contiguous(), None, None


def split_to_group(x: torch.Tensor, group=None, *,
                   axis: int = 0) -> torch.Tensor:
    """This rank's 1/N slice of ``x`` along ``axis``, where every rank of
    ``group`` holds the same ``x`` and computes the same loss from the
    slices: the backward gathers the slices' gradients, so each rank gets
    the gradient of the whole ``x``."""
    group = resolve_group(group)
    if group is None:
        return x
    if x.shape[axis] % group.size():
        raise ValueError(f"axis {axis} of {tuple(x.shape)} does not split "
                         f"over {group.size()} ranks")
    if x.requires_grad and torch.is_grad_enabled():
        return _SplitToGroup.apply(x, group, axis)
    return x.chunk(group.size(), axis)[group.rank()]


def gather_from_group(x: torch.Tensor, group=None, *,
                      axis: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``axis`` in rank order, where
    every rank then computes the same loss from the whole: the gradient
    of this rank's ``x`` is its slice of the whole's, without a sum over
    the ranks (:func:`all_gather` sums, for losses that are shares)."""
    group = resolve_group(group)
    if group is None:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _GatherFromGroup.apply(x, group, axis)
    return torch.cat(_gather_list(x, group), axis)


def broadcast(x: torch.Tensor, group=None, *, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank (a new tensor)."""
    group = resolve_group(group)
    if group is None:
        return x
    y = x.detach().contiguous().clone()
    opts = dist.BroadcastOptions()
    opts.rootRank = src
    opts.rootTensor = 0
    group.broadcast([y], opts).wait()
    return y


def pack_by_size(leaves: Sequence[torch.Tensor],
                 bytes_per_pack: int) -> list[list[int]]:
    """Greedy bucketing of leaf indices in order; a pack never mixes
    dtypes (a concatenation would promote them)."""
    if bytes_per_pack <= 0:
        return [[i] for i in range(len(leaves))]
    packs: list[list[int]] = []
    cur: list[int] = []
    cur_bytes = 0
    cur_dtype = None
    for i, leaf in enumerate(leaves):
        nbytes = leaf.numel() * leaf.element_size()
        if cur and (cur_bytes + nbytes > bytes_per_pack
                    or leaf.dtype != cur_dtype):
            packs.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
        cur_dtype = leaf.dtype
    if cur:
        packs.append(cur)
    return packs


def packed_all_reduce(tree, group=None, *, options: Options | None = None,
                      op: ReduceOp = ReduceOp.SUM):
    """A list, tuple or dict of tensors all-reduced with the
    flatten-concat-reduce-split packing of ``options.bytes_per_pack``;
    the same structure back (the tensors themselves for a world of
    one)."""
    group = resolve_group(group)
    if group is None:
        return tree
    options = options or Options()
    keys = list(tree) if isinstance(tree, dict) else None
    leaves: list[Any] = [tree[k] for k in keys] if keys else list(tree)
    out: list[Any] = [None] * len(leaves)
    for pack in pack_by_size(leaves, options.bytes_per_pack):
        flat = torch.cat([leaves[i].detach().reshape(-1) for i in pack]) \
            if len(pack) > 1 else leaves[pack[0]].detach().contiguous().clone()
        _all_reduce_(flat, group, op)
        offset = 0
        for i in pack:
            n = leaves[i].numel()
            out[i] = flat[offset:offset + n].view(leaves[i].shape)
            offset += n
    if keys:
        return dict(zip(keys, out))
    return type(tree)(out) if isinstance(tree, tuple) else out


def share_of_mean(count, group=None):
    """``max(count, 1) / max(sum of count over the ranks, 1)``: a rank's
    mean over its ``count`` weights times this is its share of the mean
    over every rank's weights (the shares sum to that mean; the factor is
    exactly 1 for a world of one).  A tensor ``count`` is summed over the
    ranks (no gradient); a Python number means every rank holds the same
    count."""
    n = group_size(group)
    if n == 1:
        return 1.0
    if not torch.is_tensor(count):
        return max(count, 1) / max(count * n, 1)
    count = count.detach().float()
    return count.clamp_min(1.0) / all_reduce(count, group).clamp_min(1.0)
