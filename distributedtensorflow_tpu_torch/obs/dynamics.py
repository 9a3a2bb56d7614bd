"""Training-dynamics observability: in-step model-internals telemetry
plus NaN/Inf provenance.

Twin of ``distributedtensorflow_tpu/obs/dynamics.py`` (``:136-755``).  The
AnomalyDetector and the nan-loss checks see only the scalar loss, so a
poisoned run carries no evidence of which layer went bad; per-layer
gradient/update statistics are the first-line divergence and numerics
diagnostic.  Two halves:

- :class:`StepStats` (JAX ``cadence_stats``) — called from the engine's
  step (``train.engine._train_one``) on the optimizer steps that are
  multiples of ``dynamics_every``: per-top-level-module gradient norm,
  parameter norm, update-to-weight ratio and non-finite gradient counts,
  plus the global gradient norm, computed on the device inside the step.
  JAX gates the stats with ``lax.cond`` inside one program; here the
  host knows the step count and runs the stats only on cadence steps, so
  a step off the cadence launches exactly what a step without dynamics
  launches (the replayed CUDA graphs of ``steps_per_call`` > 1 are
  captured once per cadence pattern, ``train.engine._GraphedSteps``).
  The gradient statistics are read before the optimizer update (which
  clips the gradients in place) and the parameters are copied in fp32
  before it (the update happens in place), so a cadence step holds one
  fp32 copy of the parameters more than other steps.  Modules are the
  first components of the parameters' flax paths
  (``models.flax_modules``), sorted as JAX sorts them (``h0, h1, h10,
  ..., ln_f, wte``), capped at :data:`MAX_MODULES` with the overflow
  folded into ``_other``.  The stats ride the step's metrics dict under
  ``dynamics/``-prefixed keys.  Over a mesh that splits the parameters
  (``model``, ``expert``, ``pipe``, or ZeRO's rows; :func:`stat_split`)
  every sum is of the whole logical tensors, as JAX's global arrays give
  it: each class of pieces (the kinds of group it is split over) sums
  its own, then each group sums the classes split over it and counts the
  others once (the clip's scheme, ``train.optimizers._split_square_sum``),
  so every rank holds the same values bit for bit.
- :class:`DynamicsMonitor` — a Trainer callback + train-step wrapper
  that pops those keys off the metrics dict before the MetricWriter
  sees them, books the on-cadence rows, and flushes them at log
  boundaries into ``dynamics.jsonl`` rows, the ``dynamics_*`` registry
  families (→ metrics.prom, flattened metrics.jsonl fields, pinned
  MetricsHistory series) and the ``GET /dynamicz`` StatusServer route.

On a non-finite loss or gradient the monitor runs a **NaN-provenance
pass** over the still-live post-step state: an activation re-forward
with per-module non-finite counts (``models.make_nan_taps``: the GPT
LM's ``taps`` dict, the twin of flax's ``sow`` into ``dynamics``), a
per-module parameter census, and a gradient re-run, each binary-searched
on a device-side prefix-OR vector so the first offending module is named
in O(log n) host syncs.  The verdict is emitted as a ``nan_provenance``
flight event, an ``incidents/<step>-nan_provenance/`` evidence bundle, a
``dynamics_provenance_total{module=}`` count, and the module-global
:func:`last_provenance` hint.

Over a mesh (``mesh``) the pass is collective: whether it runs is one
flag all-reduced over the mesh's ranks at each log boundary (the
cadence rows, bit-equal across ranks, and the global loss), so every
rank enters it together; the taps are summed over the batch group (and
over ``seq`` by the tap forward itself), the censuses as the cadence
stats; only the chief, which alone has a ``logdir``, writes the
incident.  The AnomalyDetector's verdict does not start it over a mesh
(one rank's verdict is not a flag every rank holds): the log boundary's
loss check catches the same non-finite loss on every rank.

Provenance fidelity contract: evidence is only sharp while the poison
is still localized.  A NaN loss makes every gradient NaN one optimizer
step later and every parameter NaN the step after that, so the pass
names a unique module when it runs at the same log boundary that
detected the bad step; past that it degrades honestly — every channel
it probed is reported, not just the winner.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import re
import threading
import time
from collections.abc import Mapping

import torch

from . import flight_recorder as frlib
from . import registry as reglib

logger = logging.getLogger(__name__)

__all__ = [
    "DynamicsMonitor",
    "StepStats",
    "first_bad_index",
    "on_cadence",
    "group_names",
    "last_provenance",
    "METRIC_PREFIX",
    "MAX_MODULES",
]

#: Metrics-dict key prefix the engine emits and the monitor pops.
METRIC_PREFIX = "dynamics/"
#: Per-module label cap: groups past this fold into ``_other`` so the
#: registry's 1024-label-set cardinality guard is never approached.
MAX_MODULES = 32
OVERFLOW_MODULE = "_other"
#: Update-to-weight ratio denominator guard (fresh zero-init modules).
_EPS = 1e-12

# tap_fn output keys may carry a forward-position prefix ("000_wte") so
# sorting the keys restores forward order; stripped before the module
# name is reported.
_TAP_ORDER_RE = re.compile(r"^\d+_")
#: /dynamicz keeps this many recent cadence rows.
_RING_ROWS = 64

_MODULE_SANITIZE_RE = re.compile(r"[^A-Za-z0-9_]")

# -- registry families (import-time: the list_metrics floor) -----------------

GRAD_NORM = reglib.gauge(
    "dynamics_grad_norm",
    "Per-top-level-module gradient L2 norm at the last dynamics cadence "
    "step (module= label).",
)
PARAM_NORM = reglib.gauge(
    "dynamics_param_norm",
    "Per-top-level-module parameter L2 norm at the last dynamics cadence "
    "step (module= label).",
)
UPDATE_RATIO = reglib.gauge(
    "dynamics_update_ratio",
    "Per-top-level-module update-to-weight ratio ||dW||/||W|| at the last "
    "dynamics cadence step (module= label).",
)
GLOBAL_GRAD_NORM = reglib.gauge(
    "dynamics_global_grad_norm",
    "Global (all-parameter) gradient L2 norm at the last dynamics "
    "cadence step.",
)
NONFINITE_GRADS = reglib.counter(
    "dynamics_nonfinite_grads_total",
    "Cumulative non-finite gradient elements observed at dynamics "
    "cadence steps, by top-level module (module= label).",
)
PROVENANCE = reglib.counter(
    "dynamics_provenance_total",
    "NaN-provenance passes that named a first offending module "
    "(module= label).",
)

# -- module-global provenance hint (/dynamicz and later consumers) -----------

_LAST_PROV: dict | None = None
_LAST_PROV_LOCK = threading.Lock()


def last_provenance() -> dict | None:
    """The most recent NaN-provenance verdict in this process (or None).
    (The JAX package's supervisor attaches it to its ``nan_loss``
    restart event; the port's resilience layer is still to come.)"""
    with _LAST_PROV_LOCK:
        return dict(_LAST_PROV) if _LAST_PROV is not None else None


def _set_last_provenance(doc: dict) -> None:
    global _LAST_PROV
    with _LAST_PROV_LOCK:
        _LAST_PROV = dict(doc)


# -- grouping ----------------------------------------------------------------


def _sanitize(name: str) -> str:
    """A parameter-path component as a metric-label-safe module name."""
    name = _MODULE_SANITIZE_RE.sub("_", str(name)) or "_"
    return name if not name[0].isdigit() else "_" + name


def _groups(names, modules: Mapping[str, str] | None = None
            ) -> list[tuple[str, list[str]]]:
    """``[(module, [parameter names])]`` by module — ``modules[name]``
    (``models.flax_modules``: the first component of the flax path), or
    the name's first dotted component — in SORTED module order, as JAX
    walks the sorted keys of its parameter dict (the provenance binary
    search depends on it), capped at :data:`MAX_MODULES` (the overflow
    folds into ``_other``)."""
    by: dict[str, list[str]] = {}
    for name in names:
        key = modules[name] if modules is not None else name.split(".")[0]
        by.setdefault(key, []).append(name)
    if not by:
        return [("params", [])]
    items = [(_sanitize(k), v)
             for k, v in sorted(by.items(), key=lambda kv: str(kv[0]))]
    if len(items) <= MAX_MODULES:
        return items
    head, tail = items[: MAX_MODULES - 1], items[MAX_MODULES - 1:]
    return head + [(OVERFLOW_MODULE, [n for _, v in tail for n in v])]


def group_names(names, modules: Mapping[str, str] | None = None
                ) -> list[str]:
    """The module names :class:`StepStats` emits for parameters ``names``
    (JAX ``group_names`` of the parameter tree)."""
    return [name for name, _ in _groups(names, modules)]


# -- in-step cadence stats (called from engine._train_one) -------------------


def _sumsq(tensors, device) -> torch.Tensor:
    """Sum of squares of ``tensors`` in fp32 (one multi-tensor norm)."""
    if not tensors:
        return torch.zeros((), dtype=torch.float32, device=device)
    norms = torch._foreach_norm([t.float() for t in tensors], 2)
    return torch.stack(norms).square().sum()


def _nonfinite(tensors, device) -> torch.Tensor:
    """Count of non-finite elements of ``tensors`` as an fp32 scalar."""
    count = torch.zeros((), dtype=torch.int32, device=device)
    for t in tensors:
        count = count + (~torch.isfinite(t)).sum(dtype=torch.int32)
    return count.float()


@dataclasses.dataclass
class StatSplit:
    """Where a step's tensors lie over a mesh (:func:`stat_split`):
    ``split`` the optimizer's ``train.optimizers.Split`` (its ``groups``,
    ``(kind, group, rank)`` in one order on every rank, and their
    ``keep`` vectors), ``grads`` and ``params`` each name's kinds of
    group that hold disjoint pieces of its gradient (ZeRO's rows add
    ``zero``) and of its parameter."""

    split: object
    grads: dict
    params: dict

    def bits(self, kinds) -> int:
        order = [k for k, _, _ in self.split.groups]
        return sum(1 << order.index(k) for k in kinds)

    def table(self, members, tensors: Mapping, kinds: Mapping, stat,
              device) -> torch.Tensor:
        """``stat(tensors of a class)`` per class of ``members`` (the
        kinds their pieces are split over, a bit each): a vector over
        the classes, the same layout on every rank."""
        by: dict[int, list] = {}
        for n in members:
            by.setdefault(self.bits(kinds[n]), []).append(tensors[n])
        return torch.stack([stat(by.get(b, []), device)
                            for b in range(1 << len(self.split.groups))])

    def reduce(self, rows: list[torch.Tensor]) -> torch.Tensor:
        """The whole sums of ``rows`` (each a :meth:`table`): over each
        group in turn the classes split over it summed and rank 0's value
        of the others (which every rank of the group holds alike)."""
        from ..parallel.collectives import all_reduce

        table = torch.stack(rows)
        for (_, group, _), keep in zip(self.split.groups,
                                       self.split.keep(table.device)):
            table = all_reduce(table * keep, group)
        return table.sum(-1)


def stat_split(state) -> StatSplit | None:
    """The :class:`StatSplit` of a ``train.TrainState`` whose parameters
    or rows are held in pieces (its optimizer has a ``split``: a
    ``parallel.placement.Placement`` or a ZeRO sharder bound it), else
    None (every rank holds the whole tensors)."""
    split = getattr(state.optimizer, "split", None)
    if split is None:
        return None
    placement, zero = state.placement, state.zero
    axes = {n: placement.axes(n) if placement is not None else ()
            for n, _ in state.model.named_parameters()}
    rows = ("zero",) if zero is not None else ()
    return StatSplit(split, {n: a + rows for n, a in axes.items()}, axes)


class StepStats:
    """Per-module dynamics stats of one optimizer step, as a flat
    ``{metric_key: fp32 scalar tensor}`` dict (JAX ``cadence_stats``'s
    on-cadence branch): :meth:`before` reads the gradients and copies
    the parameters ahead of the optimizer update, :meth:`after` adds the
    parameter norms and update ratios from the updated parameters.  No
    host sync.  With a ``split`` (:func:`stat_split`) each sum is over
    the whole logical tensors (collectives over the split groups; under
    ZeRO the gradients are this rank's rows)."""

    def __init__(self, names, modules: Mapping[str, str] | None = None,
                 split: StatSplit | None = None):
        self.groups = _groups(list(names), modules)
        self.split = split

    def before(self, model, grads: Mapping) -> tuple[dict, dict]:
        """``(stats, old)``: the gradient norms and non-finite counts by
        module and the global gradient norm, and an fp32 copy of every
        parameter by name (the update runs in place)."""
        params = dict(model.named_parameters())
        device = next(iter(params.values())).device
        if self.split is not None:
            sp = self.split
            rows = [sp.table(members, grads, sp.grads, stat, device)
                    for _, members in self.groups
                    for stat in (_sumsq, _nonfinite)]
            sums = sp.reduce(rows).unbind(0)
            gsqs, counts = sums[0::2], sums[1::2]
        else:
            gsqs, counts = [], []
            for _, members in self.groups:
                g = [grads[n] for n in members]
                gsqs.append(_sumsq(g, device))
                counts.append(_nonfinite(g, device))
        out = {}
        global_sq = torch.zeros((), dtype=torch.float32, device=device)
        for (name, _), gsq, count in zip(self.groups, gsqs, counts):
            global_sq = global_sq + gsq
            out[f"{METRIC_PREFIX}grad_norm/{name}"] = torch.sqrt(gsq)
            out[f"{METRIC_PREFIX}nonfinite/{name}"] = count
        out[f"{METRIC_PREFIX}global_grad_norm"] = torch.sqrt(global_sq)
        with torch.no_grad():
            old = {n: params[n].detach().float().clone()
                   for _, members in self.groups for n in members}
        return out, old

    def after(self, model, stats: dict, old: dict) -> dict:
        """``stats`` with each module's parameter norm (of ``old``) and
        update-to-weight ratio (of the updated parameters against
        ``old``)."""
        params = dict(model.named_parameters())
        device = stats[f"{METRIC_PREFIX}global_grad_norm"].device
        sp = self.split
        with torch.no_grad():
            psqs, usqs = [], []
            for _, members in self.groups:
                o = [old[n] for n in members]
                diff = dict(zip(members, torch._foreach_sub(
                    [params[n].detach().float() for n in members], o)))
                if sp is None:
                    psqs.append(_sumsq(o, device))
                    usqs.append(_sumsq(list(diff.values()), device))
                else:
                    psqs.append(sp.table(members, old, sp.params, _sumsq,
                                         device))
                    usqs.append(sp.table(members, diff, sp.params, _sumsq,
                                         device))
            if sp is not None:
                sums = sp.reduce(psqs + usqs).unbind(0)
                psqs, usqs = sums[:len(psqs)], sums[len(psqs):]
            for (name, _), psq, usq in zip(self.groups, psqs, usqs):
                pnorm = torch.sqrt(psq)
                stats[f"{METRIC_PREFIX}param_norm/{name}"] = pnorm
                stats[f"{METRIC_PREFIX}update_ratio/{name}"] = \
                    torch.sqrt(usq) / (pnorm + _EPS)
        return stats


def on_cadence(step: int, every: int) -> bool:
    """Whether the optimizer step that ``step`` (the pre-increment count)
    starts lands on the cadence: completed steps that are multiples of
    ``every``, as JAX's ``(step + 1) % every == 0``."""
    return every > 0 and (int(step) + 1) % every == 0


# -- provenance binary search ------------------------------------------------


def first_bad_index(prefix) -> int | None:
    """First True index of a device-side prefix-OR boolean vector, found
    with O(log n) host syncs (one ``bool()`` per probe); None when no
    element is set."""
    n = int(prefix.shape[0]) if prefix.ndim else 0
    if n == 0 or not bool(prefix[-1]):
        return None
    lo, hi = 0, n - 1
    while lo < hi:
        mid = (lo + hi) // 2
        if bool(prefix[mid]):
            hi = mid
        else:
            lo = mid + 1
    return lo


def _json_value(v):
    """A float as a JSON-safe value: sentinel strings for non-finite
    (``json.dumps(nan)`` emits an invalid-JSON bare token)."""
    if isinstance(v, float) and not math.isfinite(v):
        if math.isnan(v):
            return "NaN"
        return "Infinity" if v > 0 else "-Infinity"
    return v


# -- the monitor -------------------------------------------------------------


class DynamicsMonitor:
    """Train-step wrapper + Trainer callback: books the in-step cadence
    stats, exports them at log boundaries, and runs the NaN-provenance
    pass when a non-finite loss or gradient surfaces.

    ``loss_fn`` is the workload's ``loss_fn(batch, generator)`` over
    the state's model (the gradient census), ``tap_fn`` the model's
    :func:`~..models.make_nan_taps` and ``modules`` its
    :func:`~..models.flax_modules` (the parameter census's groups: those
    of :class:`StepStats`).  ``mesh``: the run's mesh, over which the
    provenance pass is agreed and run together (module docstring).

    Duck-typed against :class:`~..train.trainer.Callback` (importing the
    trainer here would cycle through ``obs/__init__``).
    """

    def __init__(
        self,
        every: int,
        *,
        logdir: str | None = None,
        loss_fn=None,
        tap_fn=None,
        log_every: int = 0,
        steps_per_call: int = 1,
        history=None,
        modules: Mapping[str, str] | None = None,
        time_fn=time.time,
        mesh=None,
    ):
        if every <= 0:
            raise ValueError(f"every must be positive, got {every}")
        self.every = int(every)
        self._flush_every = max(int(log_every), 0) or self.every
        self._steps_per_call = max(int(steps_per_call), 1)
        self._loss_fn = loss_fn
        self._tap_fn = tap_fn
        self._modules = modules
        self._mesh = mesh
        self._history = history
        self._time = time_fn
        self._logdir = logdir
        self._log = None
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            self._log = open(os.path.join(logdir, "dynamics.jsonl"), "a")
        self._pending: dict | None = None  # popped dyn arrays, last dispatch
        self._last = None                  # (state, batch) still live
        self._stash: list[tuple[int, dict]] = []  # on-cadence rows to flush
        self._ring: list[dict] = []
        self._module_names: list[str] = []
        self._pinned = False
        self._prev_step: int | None = None
        self.last_prov: dict | None = None
        self.flushes = 0
        self.rows_written = 0

    # -- train-step wrapper --------------------------------------------------

    def wrap_train_step(self, train_step):
        """``(state, batch) -> (state, metrics)`` with the ``dynamics/``
        keys popped into the monitor (the MetricWriter never sees them)
        and the dispatch's refs stashed for a possible provenance pass.
        No host sync is added."""

        def dynamics_step(state, batch):
            new_state, metrics = train_step(state, batch)
            dyn = {k: metrics[k] for k in metrics
                   if isinstance(k, str) and k.startswith(METRIC_PREFIX)}
            if dyn:
                metrics = {k: v for k, v in metrics.items() if k not in dyn}
                self._pending = dyn
            self._last = (new_state, batch)
            return new_state, metrics

        return dynamics_step

    # -- Callback protocol ---------------------------------------------------

    def on_fit_begin(self, trainer, state) -> None:
        try:
            self._prev_step = int(state.step)
        except Exception:
            self._prev_step = None

    def on_step_end(self, trainer, step: int, state, metrics: dict) -> None:
        """Book the dispatch's on-cadence sub-steps (host modular
        arithmetic only) and flush at log-boundary crossings.  Runs
        outside the trainer's callback guard — must never raise."""
        try:
            self._on_step_end(step, metrics)
        except Exception:
            logger.exception("dynamics on_step_end failed")

    def _on_step_end(self, step: int, metrics: dict) -> None:
        prev = self._prev_step if self._prev_step is not None \
            else step - self._steps_per_call
        self._prev_step = step
        dyn, self._pending = self._pending, None
        if dyn:
            # The pending arrays came from ONE dispatch, which covered
            # exactly (step - k, step] for the k steps it stacked (a short
            # last call stacks fewer than steps_per_call) — index
            # sub-steps against that base, not against prev (a restart
            # can make the two differ).
            stacked = self._steps_per_call > 1
            k = int(next(iter(dyn.values())).shape[0]) if stacked else 1
            base = step - k
            for s in range(max(prev, base) + 1, step + 1):
                if s % self.every != 0:
                    continue
                idx = s - base - 1
                self._stash.append((s, {
                    key: (v[idx] if stacked else v)
                    for key, v in dyn.items()
                }))
        if self._crosses(prev, step, self._flush_every):
            self.flush()
            loss = metrics.get("loss")
            bad = False
            if loss is not None:
                # The boundary block float()s every metric right after
                # this callback anyway — peeking the loss here costs the
                # same sync one call earlier, and catches the poison
                # while it is still localized to one module.
                try:
                    bad = not math.isfinite(float(loss))
                except (TypeError, ValueError):
                    pass
            if self._agree(step if bad else None) is not None:
                self.maybe_provenance(step, "non_finite_loss")

    def on_log(self, trainer, step, record) -> None: ...

    def on_eval_end(self, trainer, step, state, eval_metrics) -> None: ...

    def on_checkpoint(self, trainer, step, state) -> None: ...

    def on_anomaly(self, trainer, anomaly) -> None:
        """The AnomalyDetector's non-finite-loss verdict: run provenance
        on the stashed still-live state (idempotent per step)."""
        if self._mesh is not None:
            return  # no flag every rank holds: the log boundary's check
        if getattr(anomaly, "kind", None) == "non_finite_loss":
            step = getattr(anomaly, "step", None)
            self.maybe_provenance(
                int(step) if step is not None else (self._prev_step or 0),
                "non_finite_loss",
            )

    def on_fit_end(self, trainer, state) -> None:
        try:
            self.flush()
        except Exception:
            logger.exception("dynamics final flush failed")

    @staticmethod
    def _crosses(lo: int, hi: int, every: int) -> bool:
        """True when (lo, hi] contains a multiple of ``every`` — the
        trainer's own log-boundary arithmetic."""
        if every <= 0:
            return False
        return (hi // every) > (lo // every)

    # -- flushing ------------------------------------------------------------

    def flush(self) -> int:
        """float() the stashed cadence rows (first host sync the stats
        ever cost), append dynamics.jsonl, set the registry families,
        pin the history series.  Returns rows written."""
        rows, self._stash = self._stash, []
        bad_step: int | None = None
        for s, arrays in rows:
            vals = {}
            for key, v in arrays.items():
                try:
                    vals[key] = float(v)
                except (TypeError, ValueError):
                    vals[key] = float("nan")
            row = self._book_row(s, vals)
            if row["nonfinite_total"] > 0 or any(
                not (isinstance(v, (int, float)) and math.isfinite(v))
                for v in (row["global_grad_norm"],)
            ):
                bad_step = s
        self.flushes += 1
        bad_step = self._agree(bad_step)
        if bad_step is not None:
            self.maybe_provenance(bad_step, "non_finite_grads")
        return len(rows)

    def _agree(self, step: int | None) -> int | None:
        """Over a mesh, the largest of the ranks' ``step`` (None: none
        asks for a pass), one all-reduce over every rank of the mesh,
        which each rank makes at the same log boundary; without one,
        ``step``."""
        if self._mesh is None or self._last is None:
            return step
        from ..parallel.collectives import ReduceOp, all_reduce

        device = next(self._last[0].model.parameters()).device
        flag = torch.tensor([-1 if step is None else int(step)],
                            dtype=torch.int64, device=device)
        out = int(all_reduce(flag, self._mesh.world, ReduceOp.MAX))
        return None if out < 0 else out

    def _book_row(self, step: int, vals: dict[str, float]) -> dict:
        modules: dict[str, dict] = {}
        nonfinite_total = 0
        for key, v in vals.items():
            rest = key[len(METRIC_PREFIX):]
            if rest == "global_grad_norm":
                continue
            stat, _, module = rest.partition("/")
            d = modules.setdefault(module, {})
            if stat == "nonfinite":
                count = int(v) if math.isfinite(v) else 0
                d["nonfinite_grads"] = count
                nonfinite_total += count
                if count > 0:
                    NONFINITE_GRADS.inc(count, module=module)
            else:
                field = {"grad_norm": "grad_norm", "param_norm": "param_norm",
                         "update_ratio": "update_ratio"}.get(stat)
                if field is None:
                    continue
                d[field] = v
                gauge = {"grad_norm": GRAD_NORM, "param_norm": PARAM_NORM,
                         "update_ratio": UPDATE_RATIO}[field]
                if math.isfinite(v):
                    gauge.set(v, module=module)
        gnorm = vals.get(f"{METRIC_PREFIX}global_grad_norm", float("nan"))
        if math.isfinite(gnorm):
            GLOBAL_GRAD_NORM.set(gnorm)
        row = {
            "t": self._time(),
            "step": int(step),
            "every": self.every,
            "global_grad_norm": gnorm,
            "nonfinite_total": nonfinite_total,
            "modules": {
                m: {k: modules[m][k] for k in sorted(modules[m])}
                for m in modules
            },
        }
        self._module_names = sorted(set(self._module_names) | set(modules))
        self._write_row(row)
        self._ring.append(self._json_row(row))
        del self._ring[:-_RING_ROWS]
        self._maybe_pin(modules)
        return row

    def _write_row(self, row: dict) -> None:
        if self._log is None:
            return
        try:
            self._log.write(json.dumps(self._json_row(row)) + "\n")
            self._log.flush()
            self.rows_written += 1
        except OSError:
            logger.exception("dynamics.jsonl write failed")

    @staticmethod
    def _json_row(row: dict) -> dict:
        out = {k: _json_value(v) for k, v in row.items() if k != "modules"}
        out["modules"] = {
            m: {k: _json_value(v) for k, v in stats.items()}
            for m, stats in row.get("modules", {}).items()
        }
        return out

    def _maybe_pin(self, modules) -> None:
        """Reserve MetricsHistory capacity for every dynamics series so a
        late-filling cap never evicts the divergence early-warning
        signal (the alert-rule pin convention)."""
        if self._history is None or self._pinned:
            return
        names = ["dynamics_global_grad_norm"]
        for m in modules:
            suffix = reglib._NAME_RE.sub("_", m)
            names += [f"dynamics_grad_norm.module_{suffix}",
                      f"dynamics_param_norm.module_{suffix}",
                      f"dynamics_update_ratio.module_{suffix}",
                      f"dynamics_nonfinite_grads_total.module_{suffix}"]
        try:
            self._history.pin(names)
            self._pinned = True
        except Exception:
            logger.exception("dynamics history pin failed")

    # -- provenance ----------------------------------------------------------

    def maybe_provenance(self, step: int, reason: str) -> dict | None:
        """Run the NaN-provenance pass at most once per offending step.
        Best-effort by design: a failed pass logs and returns None, never
        takes the fit down."""
        if self._last is None:
            return None
        if self.last_prov is not None and step <= self.last_prov["step"]:
            return None
        try:
            doc = self._provenance(int(step), reason)
        except Exception:
            logger.exception("nan provenance pass failed")
            return None
        self.last_prov = doc
        _set_last_provenance(doc)
        return doc

    def _provenance(self, step: int, reason: str) -> dict:
        from ..models.layers import DropoutKey

        state, batch = self._last
        model = state.model
        params = dict(model.named_parameters())
        groups = _groups(list(params), self._modules)
        names = [name for name, _ in groups]
        mesh = self._mesh
        split = stat_split(state) if mesh is not None else None
        sub_batch = batch
        if self._steps_per_call > 1:
            sub_batch = {k: x[-1] for k, x in batch.items()}

        device = next(iter(params.values())).device

        def census(tensors_by_group):
            counts = torch.stack([
                sum(((~torch.isfinite(t)).sum(dtype=torch.int32)
                     for t in ts),
                    start=torch.zeros((), dtype=torch.int32, device=device))
                for ts in tensors_by_group
            ])
            return counts, torch.cumsum(counts, 0) > 0

        # 1) activation taps: a re-forward with per-module non-finite
        #    counts (forward order — the sharpest "first offending"
        #    signal).  The tap_fn keys carry the forward position
        #    ("000_wte", "001_h0", ...): sorting restores forward order
        #    and the prefix is stripped before reporting.
        first_act = None
        act_counts: dict[str, int] = {}
        if self._tap_fn is not None:
            try:
                taps = self._tap_fn(sub_batch)
                keys = sorted(taps)
                tap_names = [_TAP_ORDER_RE.sub("", k) for k in keys]
                if tap_names:
                    vec = torch.stack([
                        torch.as_tensor(taps[k]).to(torch.int32).sum()
                        for k in keys
                    ])
                    if mesh is not None:  # every replica's rows
                        from ..parallel.collectives import all_reduce

                        vec = all_reduce(vec, mesh.batch_group)
                    idx = first_bad_index(torch.cumsum(vec, 0) > 0)
                    if idx is not None:
                        first_act = tap_names[idx]
                        act_counts = {
                            n: int(v)
                            for n, v in zip(tap_names, vec.tolist())
                            if int(v) > 0
                        }
            except Exception:
                logger.exception("provenance activation taps failed")

        # 2) parameter census: which module subtrees already hold
        #    non-finite values (model-agnostic; names the poisoned module
        #    alone while the damage is still localized).
        first_param = None
        param_counts: dict[str, int] = {}
        try:
            with torch.no_grad():
                if split is not None:  # the whole tensors' counts
                    counts_d = split.reduce([
                        split.table(members, params, split.params,
                                    _nonfinite, device)
                        for _, members in groups]).round().to(torch.int32)
                    prefix_d = torch.cumsum(counts_d, 0) > 0
                else:
                    counts_d, prefix_d = census(
                        [[params[n] for n in members]
                         for _, members in groups])
            idx = first_bad_index(prefix_d)
            if idx is not None:
                first_param = names[idx]
                param_counts = {
                    n: int(v) for n, v in zip(names, counts_d.tolist())
                    if int(v) > 0
                }
        except Exception:
            logger.exception("provenance parameter census failed")

        # 3) gradient re-run: weakest channel (one NaN loss poisons every
        #    cotangent) but the only one that sees a grads-only event.
        first_grad = None
        if self._loss_fn is not None:
            try:
                loss, _ = self._loss_fn(sub_batch, DropoutKey(0))
                grads = torch.autograd.grad(
                    loss, list(params.values()), allow_unused=True,
                    materialize_grads=True)
                by_name = dict(zip(params, grads))
                counts_g, prefix_g = census(
                    [[by_name[n] for n in members] for _, members in groups])
                if mesh is not None:  # a verdict every rank shares
                    from ..parallel.collectives import all_reduce

                    counts_g = all_reduce(counts_g, mesh.world)
                    prefix_g = torch.cumsum(counts_g, 0) > 0
                idx = first_bad_index(prefix_g)
                if idx is not None:
                    first_grad = names[idx]
            except Exception:
                logger.exception("provenance gradient census failed")

        module = first_act or first_param or first_grad or ""
        method = ("activation_taps" if first_act
                  else "param_census" if first_param
                  else "grad_census" if first_grad else "none")
        doc = {
            "t": self._time(),
            "step": int(step),
            "reason": reason,
            "module": module,
            "method": method,
            "first_bad_activation": first_act,
            "first_bad_param_module": first_param,
            "first_bad_grad_module": first_grad,
            "nonfinite_activation_counts": act_counts,
            "nonfinite_param_counts": param_counts,
            "modules_searched": len(names),
        }
        if module:
            PROVENANCE.inc(module=module)
        logger.error(
            "nan provenance: module %r produced the first non-finite value "
            "at step %d (%s, via %s)", module or "?", step, reason, method)
        frlib.record_event(
            "nan_provenance", step=int(step), module=module, reason=reason,
            method=method, first_bad_activation=first_act,
            first_bad_param_module=first_param,
            first_bad_grad_module=first_grad,
        )
        self._write_incident(doc)
        return doc

    def _write_incident(self, doc: dict) -> None:
        """An incident evidence bundle next to the alert manager's
        (``incidents/<step>-nan_provenance/``, same manifest schema the
        schema checker validates).  Best-effort."""
        if not self._logdir:
            return
        try:
            d = os.path.join(self._logdir, "incidents",
                             f"{doc['step']:04d}-nan_provenance")
            os.makedirs(d, exist_ok=True)
            files = []

            def _put(name, payload):
                with open(os.path.join(d, name), "w") as f:
                    json.dump(payload, f, indent=1, default=str)
                files.append(name)

            _put("provenance.json", doc)
            if self._ring:
                _put("dynamics.json", self._ring[-16:])
            manifest = {
                "id": int(doc["step"]), "t": doc["t"],
                "rule": "nan_provenance", "kind": "anomaly",
                "severity": "page",
                "labels": {"module": doc["module"]},
                "value": float(sum(doc["nonfinite_param_counts"].values())),
                "reason": f"{doc['reason']}: module "
                          f"{doc['module'] or '?'} first non-finite "
                          f"(via {doc['method']})",
                "files": sorted(files),
            }
            tmp = os.path.join(d, "manifest.json.tmp")
            with open(tmp, "w") as f:
                json.dump(manifest, f, indent=1)
            os.replace(tmp, os.path.join(d, "manifest.json"))
        except Exception:
            logger.exception("nan provenance incident bundle failed")

    # -- /dynamicz -----------------------------------------------------------

    def dynamicz(self, query: str = "") -> tuple[int, object]:
        """``GET /dynamicz`` handler (StatusServer extra-route shape);
        ``?n=K`` bounds the ring to the newest K rows."""
        prov = None
        if self.last_prov is not None:
            prov = {k: _json_value(v) for k, v in self.last_prov.items()}
        rows = list(self._ring)
        for part in (query or "").split("&"):
            if part.startswith("n="):
                try:
                    k = int(part[2:])
                except ValueError:
                    return 400, {"error": f"bad n: {part[2:]!r}"}
                if k >= 0:  # rows[-0:] would be the FULL list
                    rows = rows[len(rows) - min(k, len(rows)):]
        return 200, {
            "every": self.every,
            "flush_every": self._flush_every,
            "modules": list(self._module_names),
            "rows_written": self.rows_written,
            "flushes": self.flushes,
            "rows": rows,
            "provenance": prov,
        }

    def install(self, server) -> "DynamicsMonitor":
        """Register ``GET /dynamicz`` on a StatusServer."""
        server.routes[("GET", "/dynamicz")] = self.dynamicz
        return self

    def attach_history(self, history) -> "DynamicsMonitor":
        """Late-attach a MetricsHistory (the fleet plane builds it after
        the trainer); the next flush pins the dynamics series."""
        self._history = history
        self._pinned = False
        return self

    def close(self) -> None:
        if self._log is not None:
            try:
                self._log.close()
            finally:
                self._log = None
