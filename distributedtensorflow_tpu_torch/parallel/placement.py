"""Where a rank's parameters live on the mesh, and their whole state.

JAX keeps every parameter as one global array, whatever its sharding:
``optax.clip_by_global_norm`` and the layer-wise optimizers (LAMB's and
LARS's trust ratios) read the norm of the whole logical array, and Orbax
saves and restores global arrays.  Here a rank holds pieces
(``parallel.sharding``): over ``model`` its slice of each tensor-parallel
parameter (``tp_rules``, the head-major q/k/v cut and the uneven vocab
split included), over ``expert`` its experts of each stack (``ep_rules``,
``parallel.moe.local_experts``), over ``pipe`` its stages' blocks
(``models.gpt_pipeline.PipelinedGPT``; the table and ``ln_f`` on every
stage), and under ZeRO its row of every parameter (``parallel.zero``).
:class:`Placement` records which pieces a rank holds, taken when
``train.state.create_sharded_state`` cuts the model, and serves three
uses:

- :meth:`Placement.bind` gives the optimizer its :class:`~..train.
  optimizers.Split`: the groups over which each parameter's gradient
  squares are summed for the global norm (counted once over every other
  group, so a replicated tensor counts once), and the groups over which
  a trust ratio's two norms are summed (``model`` and ``expert``; under
  ZeRO none: the rows' own, as JAX's ZeRO, which warns).  Adafactor's
  factored statistics over a split parameter are not ported: it raises.
- :meth:`Placement.gather_tree` puts the whole state together on every
  rank (collectives over the split groups): the parameters and buffers
  under the dense model's names and the optimizer's ``state_dict`` in the
  one-process parameter order, its ZeRO slots as their ``(degree,
  chunk)`` views of the whole tensor, as ``ZeroSharder.gather_opt_state``
  saves them.  A checkpoint of a split run is the file one process writes
  for the same state.
- :meth:`Placement.cut_tree` takes such a whole tree (of any layout, one
  process's included) to this rank's pieces, which
  ``checkpoint.CheckpointManager`` then checks against the rank's own
  state and loads.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import collectives
from . import mesh as mesh_lib
from . import zero as zero_lib

#: The kinds of group a parameter's pieces can be split over, in the
#: order every rank reduces over them.
KINDS = ("model", "expert", "pipe", "zero")


def _gather_cut(t: torch.Tensor, dim: int, segments, size: int, group,
                n: int) -> torch.Tensor:
    """The whole tensor (``size`` along ``dim``) from every model rank's
    ``shard_tensor`` slice ``t``: the slices padded to the widest one,
    gathered, trimmed and put back together (``unshard_tensors``)."""
    from .sharding import shard_bounds, unshard_tensors

    segments = tuple(segments or (size,))
    widths = [sum(hi - lo for lo, hi in (shard_bounds(w, r, n)
                                         for w in segments))
              for r in range(n)]
    pad = max(widths) - t.shape[dim]
    if pad:
        shape = list(t.shape)
        shape[dim] = pad
        t = torch.cat([t, t.new_zeros(shape)], dim)
    parts = collectives.all_gather(t.contiguous(), group,
                                   tiled=False).unbind(0)
    parts = [p.narrow(dim, 0, w) for p, w in zip(parts, widths)]
    return unshard_tensors(parts, dim, segments if len(segments) > 1
                           else None)


def _stage_of(layers: list[int], q_layers: list[int], name: str) -> str:
    """``name`` (a block's, ``h.<layer>.*``) moved to the layer that holds
    its place in another stage's ``q_layers``."""
    _, layer, rest = name.split(".", 2)
    return f"h.{q_layers[layers.index(int(layer))]}.{rest}"


@dataclasses.dataclass
class Placement:
    """The pieces of ``model`` this rank holds over ``mesh``: ``tp`` (port
    name -> ``(dim, segments)``, ``parallel.sharding.tp_rules``), the
    expert stacks cut over ``expert`` (``experts``), whether the model is
    one pipe rank's stage (``pipe``), ZeRO's sharder (``zero``, set by
    :meth:`bind`), and ``whole`` (name -> shape of every parameter and
    buffer before the cut)."""

    model: torch.nn.Module
    mesh: object
    cfg: object
    tp: dict
    experts: set
    pipe: bool
    whole: dict
    zero: object = None
    #: per optimizer parameter group, the dense names in the one-process
    #: order (over ``pipe`` only: a stage's groups hold its own names)
    _whole_groups: list | None = None
    _dense: list | None = None

    @classmethod
    def of(cls, model, mesh, *, cfg, layout) -> "Placement":
        """The placement that ``create_sharded_state`` is about to cut
        ``model`` (whole, its weights loaded) into."""
        from .sharding import ep_rules, tp_rules

        tp, experts = {}, set()
        if layout is not None and mesh.shape[mesh_lib.AXIS_MODEL] > 1:
            tp = tp_rules(model, cfg, layout)
        if layout is not None and mesh.shape[mesh_lib.AXIS_EXPERT] > 1:
            names = {n for n, _ in model.named_parameters()}
            experts = set(ep_rules(cfg, layout)) & names
        whole = {n: tuple(t.shape) for n, t in model.state_dict().items()}
        return cls(model, mesh, cfg, tp, experts,
                   mesh.shape[mesh_lib.AXIS_PIPE] > 1, whole)

    @property
    def split(self) -> bool:
        """Whether any parameter is held in pieces over model, expert or
        pipe (without, nothing of this module runs)."""
        return bool(self.tp or self.experts or self.pipe)

    def axes(self, name: str) -> tuple[str, ...]:
        """The kinds of group that hold disjoint pieces of ``name``."""
        out = []
        if name in self.tp:
            out.append("model")
        if name in self.experts:
            out.append("expert")
        if self.pipe and name.startswith("h."):
            out.append("pipe")
        return tuple(out)

    def _group(self, kind: str):
        if kind == "zero":
            return self.zero.group
        return getattr(self.mesh, f"{kind}_group")

    # --- the optimizer -------------------------------------------------------

    def bind(self, optimizer, zero=None) -> None:
        """Give ``optimizer`` (over the model's parameters, or ZeRO's rows
        of them) its ``split``; over ``pipe`` also record the one-process
        order of its groups (an all-gather over the stages)."""
        from ..train.optimizers import Adafactor, Split

        self.zero = zero
        kinds = [k for k in KINDS if
                 (k == "model" and self.tp) or (k == "expert" and self.experts)
                 or (k == "pipe" and self.pipe)
                 or (k == "zero" and zero is not None)]
        groups = [(k, self._group(k), collectives.group_rank(self._group(k)))
                  for k in kinds]
        norm, stats = {}, {}
        for name, t in self._named(optimizer):
            axes = self.axes(name)
            norm[id(t)] = axes + (("zero",) if zero is not None else ())
            stats[id(t)] = () if zero is not None else tuple(
                self._group(k) for k in axes if k in ("model", "expert"))
        if isinstance(optimizer, Adafactor) and any(stats.values()):
            raise NotImplementedError(
                "adafactor over a model or expert axis is not ported (its "
                "factored moments and RMS terms span the whole parameter)")
        optimizer.split = Split(groups, norm, stats)
        if self.pipe:
            self._whole_groups = self._pipe_groups(optimizer)

    def _named(self, optimizer) -> list[tuple[str, torch.Tensor]]:
        """``(name, tensor)`` of the optimizer's parameters, in its
        ``state_dict`` index order."""
        if self.zero is not None:
            by_id = {id(c): n for n, c in zip(self.zero.names,
                                              self.zero.chunks)}
        else:
            by_id = {id(p): n for n, p in self.model.named_parameters()}
        return [(by_id[id(t)], t) for g in optimizer.param_groups
                for t in g["params"]]

    def _stage_layers(self, stage: int) -> list[int]:
        from ..models.gpt_pipeline import stage_layers

        m = self.model
        return [i for chunk in stage_layers(self.cfg.num_layers, m.n_stages,
                                            m.n_virtual, stage)
                for i in chunk]

    def _dense_names(self) -> list[str]:
        """The dense model's state names in its order (``GPTLM``'s)."""
        from ..models.gpt import GPTLM

        if self._dense is None:
            self._dense = list(GPTLM(self.cfg, device="meta").state_dict())
        return self._dense

    def _pipe_groups(self, optimizer) -> list[list[str]]:
        """Per parameter group, the dense names of every stage's members in
        the dense model's order: the group each stage's parameters are in
        is gathered over ``pipe``."""
        named = self._named(optimizer)
        gid = [i for i, g in enumerate(optimizer.param_groups)
               for _ in g["params"]]
        ids = collectives.all_gather(torch.tensor(gid, dtype=torch.int64),
                                     self.mesh.pipe_group, tiled=False)
        own = self._stage_layers(self.model.stage)
        group_of = {}
        for q, row in enumerate(ids.tolist()):
            layers = self._stage_layers(q)
            for (name, _), g in zip(named, row):
                if name.startswith("h."):
                    name = _stage_of(own, layers, name)
                group_of.setdefault(name, g)
        return [[n for n in self._dense_names() if group_of.get(n) == g]
                for g in range(len(optimizer.param_groups))]

    # --- the whole state ---------------------------------------------------

    def whole_piece(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """``t`` (shaped as this rank's piece of ``name``) put together over
        ``model`` and ``expert`` (collectives over those groups)."""
        if name in self.tp:
            dim, segments = self.tp[name]
            n = self.mesh.shape[mesh_lib.AXIS_MODEL]
            t = _gather_cut(t, dim, segments, self.whole[name][dim],
                            self.mesh.model_group, n)
        if name in self.experts:
            t = collectives.all_gather(t.contiguous(),
                                       self.mesh.expert_group)
        return t

    def _cut(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's piece of the whole ``t`` of ``name`` over ``model``
        and ``expert`` (the cuts of ``create_sharded_state``)."""
        from .moe import local_experts
        from .sharding import shard_tensor

        if name in self.tp:
            dim, segments = self.tp[name]
            t = shard_tensor(t, dim, self.mesh.coords[mesh_lib.AXIS_MODEL],
                             self.mesh.shape[mesh_lib.AXIS_MODEL], segments)
        if name in self.experts:
            t = local_experts(t, self.mesh.shape[mesh_lib.AXIS_EXPERT],
                              self.mesh.coords[mesh_lib.AXIS_EXPERT])
        return t.clone()

    def _stage_names(self, name: str) -> list[str]:
        """A block's ``name`` on each stage, in stage order (its own name
        for a tensor every stage holds)."""
        if not (self.pipe and name.startswith("h.")):
            return [name]
        own = self._stage_layers(self.model.stage)
        return [_stage_of(own, self._stage_layers(q), name)
                for q in range(self.model.n_stages)]

    def _over_pipe(self, name: str, t):
        """``[(name, value)]`` of every stage for a block's ``name`` (a
        tensor gathered over ``pipe``), else ``[(name, t)]``."""
        names = self._stage_names(name)
        if len(names) == 1 or not torch.is_tensor(t):
            return [(name, t)]
        parts = collectives.all_gather(t.contiguous(), self.mesh.pipe_group,
                                       tiled=False).unbind(0)
        return list(zip(names, parts))

    def gather(self, tensors: dict) -> dict:
        """The whole tensors of this rank's ``tensors`` (name -> piece: a
        ``state_dict`` or the named parameters), under the dense names in
        the dense model's order: every rank calls this, in one order."""
        whole = {}
        for name, t in tensors.items():
            for k, v in self._over_pipe(name, self.whole_piece(name, t)):
                whole[k] = v
        if self.pipe:
            whole = {k: whole[k] for k in self._dense_names() if k in whole}
        return whole

    def gather_params(self, model) -> dict:
        """The whole parameters of ``model`` (detached)."""
        return self.gather({k: p.detach()
                            for k, p in model.named_parameters()})

    def gather_tree(self, state) -> dict:
        """The checkpoint tree of ``state`` (``checkpoint.as_tree``'s keys)
        as one process holds it: every rank calls this, in one order."""
        params = {n for n, _ in state.model.named_parameters()}
        names = {k for n in params for k in self._stage_names(n)}
        whole = self.gather(state.model.state_dict())
        return {"step": int(state.step),
                "params": {k: v for k, v in whole.items() if k in names},
                "model_state": {k: v for k, v in whole.items()
                                if k not in names},
                "opt_state": self._gather_opt(state.optimizer)}

    def _gather_opt(self, optimizer) -> dict:
        sd = optimizer.state_dict()
        zero = self.zero
        if zero is not None:
            sd = zero.gather_opt_state(sd, optimizer)
        named = self._named(optimizer)
        entries = {}
        for i, (name, t) in enumerate(named):
            split = name in self.tp or name in self.experts
            shard = tuple(zero.params[zero.names.index(name)].shape) \
                if zero is not None else tuple(t.shape)
            rows = zero_lib.chunk_shape(shard, zero.degree) \
                if zero is not None else None
            entry = {}
            for k, v in sd["state"].get(i, {}).items():
                if torch.is_tensor(v) and tuple(v.shape) in (shard, rows):
                    if zero is not None:
                        v = zero_lib.unchunk_array(v, shard)
                    if split:
                        v = self.whole_piece(name, v)
                    if zero is not None:
                        v = zero_lib.chunk_array(v, zero.degree)
                entry[k] = v
            entries[i] = entry
        if not self.pipe:
            return dict(sd, state={i: e for i, e in entries.items() if e})
        index = {n: j for j, n in enumerate(
            n for group in self._whole_groups for n in group)}
        state = {}
        for i, (name, _) in enumerate(named):
            slots = {k: self._over_pipe(name, v)
                     for k, v in sorted(entries[i].items())}
            for q, n in enumerate(self._stage_names(name)):
                state[index[n]] = {k: vals[q if len(vals) > 1 else 0][1]
                                   for k, vals in slots.items()}
        state = {j: state[j] for j in sorted(state) if state[j]}
        groups, start = [], 0
        for g, members in zip(sd["param_groups"], self._whole_groups):
            groups.append(dict(g, params=list(range(start,
                                                    start + len(members)))))
            start += len(members)
        return {"state": state, "param_groups": groups}

    def cut_tree(self, tree: dict, optimizer) -> dict:
        """This rank's pieces of a whole checkpoint ``tree`` (any layout's:
        the optimizer slots whole or in ZeRO's ``(degree, chunk)`` views),
        in the rank's own order; ZeRO's rows are cut afterwards by
        ``parallel.zero.localize_opt_state``.  No collective."""
        own = set(self.model.state_dict())

        def cut_all(part):
            return {k: self._cut(k, v) for k, v in part.items() if k in own}

        out = dict(tree, params=cut_all(tree["params"]),
                   model_state=cut_all(tree["model_state"]))
        saved = tree["opt_state"]
        named = self._named(optimizer)
        index = {n: j for j, n in enumerate(
            n for group in self._whole_groups for n in group)} \
            if self.pipe else {n: j for j, (n, _) in enumerate(named)}
        state = {}
        for i, (name, _) in enumerate(named):
            j = index[name]
            whole = self.whole[name]
            entry = {}
            for k, v in saved["state"].get(j, {}).items():
                if torch.is_tensor(v) and v.dim():
                    v = _as_whole(v, whole)
                    if tuple(v.shape) == whole:
                        v = self._cut(name, v)
                entry[k] = v
            if entry:
                state[i] = entry
        own_groups = optimizer.state_dict()["param_groups"]
        if len(saved["param_groups"]) != len(own_groups):
            raise ValueError(f"optimizer groups: saved "
                             f"{len(saved['param_groups'])}, the target has "
                             f"{len(own_groups)}")
        groups = [dict(s, params=o["params"])
                  for s, o in zip(saved["param_groups"], own_groups)]
        out["opt_state"] = {"state": state, "param_groups": groups}
        return out


def _as_whole(v: torch.Tensor, shape: tuple) -> torch.Tensor:
    """A saved slot of a parameter of ``shape``: as it is when it has that
    shape, unchunked when it is a ZeRO ``(degree, chunk)`` view of it."""
    if tuple(v.shape) == shape:
        return v
    size = math.prod(shape) if shape else 1
    if v.dim() == 2 and tuple(v.shape) == zero_lib.chunk_shape(shape,
                                                               v.shape[0]) \
            and v.numel() >= size:
        return zero_lib.unchunk_array(v, shape)
    return v
