"""Collectives of the port over ``torch.distributed`` process groups.

Twin of ``distributedtensorflow_tpu/parallel/collectives.py``:
:class:`ReduceOp`, :class:`Options`, :func:`all_reduce`,
:func:`tree_all_reduce`, :func:`all_gather`, :func:`reduce_scatter`,
:func:`broadcast`, :func:`pack_by_size` and :func:`packed_all_reduce`
(``:99-212,273-388``).  JAX names a mesh axis inside one SPMD program;
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
the backward of a gather is that sum's own slice.  Gloo takes CUDA
tensors for all-reduce and broadcast only, so a gather of a CUDA tensor
over gloo goes through the host.  ``all_to_all``, ``permute``, ``shift``
and the ``gspmd_*`` constraints wait for the parallelism that needs them.
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


def resolve_group(group=None):
    """The process group behind ``group`` (a group, a mesh or None), or
    None for a world of one without a group."""
    group = getattr(group, "group", group)
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


def reduce_scatter(x: torch.Tensor, group=None, *,
                   scatter_axis: int = 0) -> torch.Tensor:
    """This rank's 1/N slice along ``scatter_axis`` of the sum over ranks
    (the sum and a slice: ZeRO, which needs the halved traffic, is not
    ported)."""
    group = resolve_group(group)
    if group is None:
        return x
    total = all_reduce(x, group)
    return total.chunk(group.size(), scatter_axis)[group.rank()]


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
