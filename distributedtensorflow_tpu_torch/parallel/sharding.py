"""Layout rules and tensor parallelism over the ``model`` axis.

Twin of ``distributedtensorflow_tpu/parallel/sharding.py``: the
partitioners (:class:`FixedShardsPartitioner`, :class:`MinSizePartitioner`,
:class:`MaxSizePartitioner`), :func:`spec_for`, :class:`LayoutMap`
(path regex -> :class:`PartitionSpec`, first match wins), :func:`path_str`,
:func:`tree_paths`, :func:`auto_fsdp_spec`, :func:`specs_for_tree` and
:func:`batch_spec`, over the flax paths of the parameters (the nested
dict of ``models.params_to_flax``, or the port's names through
``models.convert``'s paths).

JAX attaches the specs to arrays and lets GSPMD partition the program.
Here every rank runs its own program on its shards, Megatron's way
(:func:`bind_tensor_parallel`): a parameter sharded by the layout is cut
into this rank's slice (:func:`shard_tensor`; rows ``ceil(n / N)`` a
rank, the last one shorter, as GSPMD pads), a dense layer whose output
features are sharded runs column-parallel and one whose input features
are runs row-parallel, each with its collectives (``models.layers.
TensorParallel``), an embedding table sharded by rows looks up its own
rows (``models.layers.embed_rows``), and the modules that hold heads
(``tp_bind``) run this rank's heads.  A fused q/k/v kernel
(``segments``) is cut head-major: each rank holds its heads of q, of k
and of v, as the reference's manual tensor parallelism re-keys it
(``models/gpt_pipeline.py:358-406``).  No DTensor: the ranks of the
tests are bare gloo groups a thread, which ``DeviceMesh`` does not take.

Expert parallelism (:func:`shard_expert_stacks`): a parameter whose spec
names ``expert`` on its leading dim (``parallel.moe.with_moe_layout``:
the MoE blocks' expert stacks) becomes this rank's E/n experts
(``parallel.moe.local_experts``); the model's MoE layers run the
all-to-all region that was bound when the model was built
(``models.gpt_moe.bind_expert_parallel``), and expect the cut stacks:
such a model runs once ``train.state.create_sharded_state`` has cut
them.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import re
from collections.abc import Mapping
from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch import nn

from . import mesh as mesh_lib

logger = logging.getLogger("distributedtensorflow_tpu_torch")

PyTree = Any


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry per dimension, a mesh
    axis name (or a tuple of them) or None (replicated); ``P()`` is fully
    replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


# --- partitioners -------------------------------------------------------------


class Partitioner:
    """How many shards a variable of a shape and dtype gets (axis 0
    only, as the reference's ``sharded_variable`` splits rows)."""

    def num_shards(self, shape: Sequence[int], dtype) -> int:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FixedShardsPartitioner(Partitioner):
    shards: int

    def num_shards(self, shape, dtype) -> int:
        return self.shards


@dataclasses.dataclass(frozen=True)
class MinSizePartitioner(Partitioner):
    """As many shards as keep each at least ``min_shard_bytes``."""

    min_shard_bytes: int = 256 << 10
    max_shards: int = 1 << 30

    def num_shards(self, shape, dtype) -> int:
        total = math.prod(shape) * np.dtype(dtype).itemsize
        return max(1, min(self.max_shards,
                          total // max(1, self.min_shard_bytes)))


@dataclasses.dataclass(frozen=True)
class MaxSizePartitioner(Partitioner):
    """As few shards as keep each at most ``max_shard_bytes``."""

    max_shard_bytes: int

    def num_shards(self, shape, dtype) -> int:
        total = math.prod(shape) * np.dtype(dtype).itemsize
        return max(1, -(-total // max(1, self.max_shard_bytes)))


def spec_for(partitioner: Partitioner, shape: Sequence[int], dtype, mesh,
             axis: str = mesh_lib.AXIS_MODEL, *, dim: int = 0
             ) -> PartitionSpec:
    """A partitioner's decision as a spec on ``axis``: sharded
    ``axis_size`` ways when it asks for at least that many shards and
    ``dim`` divides evenly, else replicated (with a warning when it
    wanted shards but the dim does not divide)."""
    n = partitioner.num_shards(shape, np.dtype(dtype))
    axis_size = mesh.shape[axis]
    if n < axis_size or axis_size <= 1 or shape[dim] % axis_size != 0:
        if n >= axis_size > 1 and shape[dim] % axis_size != 0:
            logger.warning(
                "spec_for: %s-byte variable shape=%s wants >=%d shards but "
                "dim %d (size %d) does not divide mesh axis %r (size %d); "
                "REPLICATING instead. Pad the dimension to a multiple of "
                "%d to shard it.",
                math.prod(shape) * np.dtype(dtype).itemsize, tuple(shape),
                n, dim, shape[dim], axis, axis_size, axis_size)
        return P()
    spec = [None] * len(shape)
    spec[dim] = axis
    return P(*spec)


class LayoutMap:
    """Ordered path regexes -> :class:`PartitionSpec`; the first rule
    whose regex ``re.search``-es the '/'-joined path wins, no match is
    replicated."""

    def __init__(self, rules: Sequence[tuple[str, PartitionSpec]] = ()):
        self._rules = [(re.compile(pat), spec) for pat, spec in rules]

    def add(self, pattern: str, spec: PartitionSpec) -> "LayoutMap":
        self._rules.append((re.compile(pattern), spec))
        return self

    def spec(self, path: str) -> PartitionSpec:
        for pat, spec in self._rules:
            if pat.search(path):
                return spec
        return P()

    def __call__(self, path: str) -> PartitionSpec:
        return self.spec(path)


def path_str(key_path: Sequence) -> str:
    """A key path (strings, or objects with ``key``/``idx``/``name``) as
    a '/'-joined string."""
    parts = []
    for k in key_path:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                k = getattr(k, attr)
                break
        parts.append(str(k))
    return "/".join(parts)


def _map_with_path(fn, tree, prefix=()):
    if isinstance(tree, Mapping):
        return {k: _map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    return fn(prefix, tree)


def tree_paths(tree: PyTree) -> PyTree:
    """The '/'-joined path of every leaf of a nested dict, same
    structure."""
    return _map_with_path(lambda kp, _: path_str(kp), tree)


def auto_fsdp_spec(shape: Sequence[int], mesh, *,
                   axis: str = mesh_lib.AXIS_FSDP,
                   min_size_to_shard: int = 2 ** 14) -> PartitionSpec:
    """The ZeRO-style weight rule: shard the largest dim that the fsdp
    axis divides; small parameters stay replicated."""
    axis_size = mesh.shape.get(axis, 1)
    if axis_size <= 1 or math.prod(shape) < min_size_to_shard:
        return P()
    candidates = [(size, i) for i, size in enumerate(shape)
                  if size % axis_size == 0 and size > 1]
    if not candidates:
        return P()
    _, dim = max(candidates)
    spec = [None] * len(shape)
    spec[dim] = axis
    return P(*spec)


def specs_for_tree(tree: PyTree, mesh,
                   rule: LayoutMap | Callable | None = None, *,
                   fsdp: bool = False) -> PyTree:
    """The :class:`PartitionSpec` of every leaf of a nested dict (leaves
    with a ``shape``): the LayoutMap's (by path) or ``rule(path,
    shape)``'s; with ``fsdp``, a leaf no rule shards takes
    :func:`auto_fsdp_spec`."""

    def leaf_spec(key_path, leaf):
        path = path_str(key_path)
        shape = tuple(getattr(leaf, "shape", ()))
        spec = P()
        if isinstance(rule, LayoutMap):
            spec = rule.spec(path)
        elif callable(rule):
            spec = rule(path, shape)
        if fsdp and spec == P():
            spec = auto_fsdp_spec(shape, mesh)
        return spec

    return _map_with_path(leaf_spec, tree)


def batch_spec(mesh, *, extra_dims: int = 0,
               leading_unsharded: int = 0) -> PartitionSpec:
    """A batch's spec: the leading dim over every batch axis (after
    ``leading_unsharded`` replicated dims, a k-step bundle's step dim)."""
    axes = mesh_lib.data_axes(mesh)
    return P(*([None] * leading_unsharded), axes if axes else None,
             *([None] * extra_dims))


# --- tensor parallelism -------------------------------------------------------


def shard_bounds(size: int, rank: int, n: int) -> tuple[int, int]:
    """Rank ``rank``'s rows of ``size`` split ``n`` ways: ``ceil(size /
    n)`` each, the last ones shorter (GSPMD's padded split)."""
    c = -(-size // n)
    return min(rank * c, size), min((rank + 1) * c, size)


def shard_tensor(t: torch.Tensor, dim: int, rank: int, n: int,
                 segments: Sequence[int] | None = None) -> torch.Tensor:
    """Rank ``rank``'s slice of ``t`` along ``dim``; with ``segments``
    (the widths of fused blocks along ``dim``, summing to its size) the
    rank's slice of each block, concatenated."""
    segments = segments or (t.shape[dim],)
    parts, off = [], 0
    for width in segments:
        lo, hi = shard_bounds(width, rank, n)
        parts.append(t.narrow(dim, off + lo, hi - lo))
        off += width
    return torch.cat(parts, dim) if len(parts) > 1 else parts[0]


def unshard_tensors(shards: Sequence[torch.Tensor], dim: int,
                    segments: Sequence[int] | None = None) -> torch.Tensor:
    """The whole tensor from every rank's :func:`shard_tensor` slice, in
    rank order."""
    n = len(shards)
    segments = segments or (sum(s.shape[dim] for s in shards),)
    blocks = []
    for width in segments:
        widths = [hi - lo for lo, hi in
                  (shard_bounds(width, r, n) for r in range(n))]
        blocks.append(widths)
    out = []
    for j, _ in enumerate(segments):
        for r, s in enumerate(shards):
            off = sum(blocks[i][r] for i in range(j))
            out.append(s.narrow(dim, off, blocks[j][r]))
    return torch.cat(out, dim)


def _model_axis(spec, axis: str = mesh_lib.AXIS_MODEL) -> int | None:
    """The dim of ``spec`` that names ``axis`` (default ``model``), or
    None."""
    for i, part in enumerate(spec):
        names = part if isinstance(part, tuple) else (part,)
        if axis in names:
            return i
    return None


def tp_rules(model: nn.Module, cfg, layout: LayoutMap
             ) -> dict[str, tuple[int, tuple[int, ...] | None]]:
    """Port parameter name -> ``(dim, segments)`` for every parameter
    that ``layout`` shards over ``model``: the dim of the port's tensor
    that is cut (a dense weight's flax kernel is (in..., out...): a
    sharded out dim cuts the (out, in) weight's rows, an in dim its
    columns; other parameters cut their leading dim) and the fused
    blocks of that dim (a q/k/v kernel's ``segments``)."""
    from ..models.convert import _param_leaves
    from ..models.layers import Dense

    leaves = _param_leaves(cfg)
    modules = dict(model.named_modules())
    rules = {}
    for name, _ in model.named_parameters():
        flax_dim = _model_axis(layout.spec("/".join(leaves[name][0])))
        if flax_dim is None:
            continue
        mod_name, attr = name.rsplit(".", 1)
        mod = modules[mod_name]
        segments = None
        if isinstance(mod, Dense) and attr == "weight":
            kshape, k = mod.kernel_shape, 0
            while math.prod(kshape[:k]) != mod.in_features:
                k += 1
            dim = 0 if flax_dim >= k else 1
            if dim == 0:
                segments = getattr(mod, "segments", None)
        elif flax_dim == 0:
            dim = 0
            if isinstance(mod, Dense):  # a bias: the weight's out blocks
                segments = getattr(mod, "segments", None)
        else:
            raise NotImplementedError(
                f"{name}: the layout shards flax dim {flax_dim}; only a "
                "dense kernel's dims or a leading dim can be cut")
        rules[name] = (dim, segments)
    return rules


def shard_state(state: dict[str, torch.Tensor], rules, rank: int, n: int
                ) -> dict[str, torch.Tensor]:
    """Rank ``rank``'s shards of a whole ``state`` (name -> tensor) by
    :func:`tp_rules`; other tensors as they are."""
    return {k: shard_tensor(v, *rules[k][:1], rank, n, rules[k][1])
            if k in rules else v for k, v in state.items()}


def unshard_states(states: Sequence[dict], rules) -> dict:
    """The whole state from every rank's :func:`shard_state` (rank
    order); an unsharded tensor is rank 0's."""
    return {k: unshard_tensors([s[k] for s in states], rules[k][0],
                               rules[k][1]) if k in rules else v
            for k, v in states[0].items()}


def _check_divides(name: str, size: int, segments, n: int) -> None:
    for width in segments or (size,):
        if width % n:
            raise ValueError(f"{name}: {width} features do not split "
                             f"evenly over model={n}")


def bind_tensor_parallel(model: nn.Module, cfg, layout: LayoutMap | None,
                         mesh) -> nn.Module:
    """Split ``model`` (whole, with its weights loaded) over the mesh's
    ``model`` axis in place: each parameter ``layout`` shards becomes this
    rank's slice, each dense layer with a sharded weight runs
    column- or row-parallel, each embedding table with sharded rows looks
    up its own rows, and every module with a ``tp_bind(rank, n, group)``
    method (the attention's local heads) is told its share.  A model with
    no layout, or a ``model`` axis of 1, is left as it is (its ranks
    compute the same replica)."""
    from ..models.layers import Dense, TensorParallel, VocabShard

    n = mesh.shape[mesh_lib.AXIS_MODEL]
    if n == 1 or layout is None:
        return model
    rank, group = mesh.coords[mesh_lib.AXIS_MODEL], mesh.model_group
    rules = tp_rules(model, cfg, layout)
    modules = dict(model.named_modules())
    with torch.no_grad():
        for name, (dim, segments) in rules.items():
            mod_name, attr = name.rsplit(".", 1)
            mod = modules[mod_name]
            full = getattr(mod, attr)
            if not isinstance(mod, nn.Embedding):
                _check_divides(name, full.shape[dim], segments, n)
            setattr(mod, attr, nn.Parameter(
                shard_tensor(full, dim, rank, n, segments).clone()))
            if isinstance(mod, nn.Embedding):
                lo, _ = shard_bounds(full.shape[0], rank, n)
                mod.tp = VocabShard(lo, full.shape[0], group)
    for mod_name, mod in modules.items():
        if not isinstance(mod, Dense):
            continue
        cut = rules.get(f"{mod_name}.weight")
        if cut is None:
            continue
        mode = "col" if cut[0] == 0 else "row"
        bias_rows = None
        if mode == "col" and mod.bias is not None \
                and f"{mod_name}.bias" not in rules:
            if cut[1]:
                raise NotImplementedError(
                    f"{mod_name}: a fused column-parallel layer with a "
                    "replicated bias")
            bias_rows = shard_bounds(mod.bias.shape[0], rank, n)
        if mode == "row" and f"{mod_name}.bias" in rules:
            raise ValueError(f"{mod_name}: a row-parallel layer's bias "
                             "cannot be sharded")
        mod.tp = TensorParallel(mode, group, bias_rows)
    for mod in modules.values():
        hook = getattr(mod, "tp_bind", None)
        if hook is not None:
            hook(rank, n, group)
    return model


# --- expert parallelism -------------------------------------------------------


def ep_rules(cfg, layout: LayoutMap) -> list[str]:
    """Port parameter names whose spec in ``layout`` shards the leading
    dim over ``expert`` (the expert stacks); raises for an ``expert``
    axis on another dim."""
    from ..models.convert import _param_leaves

    names = []
    for name, (path, _, _) in _param_leaves(cfg).items():
        dim = _model_axis(layout.spec("/".join(path)), mesh_lib.AXIS_EXPERT)
        if dim is None:
            continue
        if dim != 0:
            raise NotImplementedError(
                f"{name}: the layout shards flax dim {dim} over expert; only "
                "the leading (expert) dim can be cut")
        names.append(name)
    return names


def shard_expert_stacks(model: nn.Module, cfg, layout: LayoutMap | None,
                        mesh) -> nn.Module:
    """Cut ``model``'s expert stacks (whole, their weights loaded) to this
    rank's E/n experts over the mesh's ``expert`` axis
    (``parallel.moe.local_experts``), in place; left as it is without a
    layout or for an ``expert`` axis of 1."""
    from .moe import local_experts

    n = mesh.shape[mesh_lib.AXIS_EXPERT]
    if n == 1 or layout is None:
        return model
    rank = mesh.coords[mesh_lib.AXIS_EXPERT]
    params = dict(model.named_parameters())
    modules = dict(model.named_modules())
    with torch.no_grad():
        for name in ep_rules(cfg, layout):
            mod_name, attr = name.rsplit(".", 1)
            setattr(modules[mod_name], attr, nn.Parameter(
                local_experts(params[name], n, rank)))
    return model
