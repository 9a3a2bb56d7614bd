"""The train and eval steps, on one device or over the ranks of a mesh.

Twin of ``distributedtensorflow_tpu/train/engine.py``: ``_step_body``
(``:251-285``) and ``accumulate_gradients`` (``:73-123``).  A step folds
the step counter into the randomness, averages gradients and metrics over
``accum_steps`` microbatches, and applies one optimizer update.  JAX
compiles the step into one program over a mesh that sees the *global*
batch; here each rank of a data-parallel mesh runs the step eagerly on
its share of the batch, and the step is built so that the sum over the
ranks is JAX's step on the global batch (:func:`accumulate_gradients_dp`).

Both steps come wrapped in the engine's first-dispatch instrument
(``engine.py:136-170``): every call counts into
``engine_dispatches_total{kind}``, and the first one, which on the card
pays the kernels' first load, cuBLAS's start-up and the step itself, is
the ``compile_<kind>`` span (the goodput ledger's ``compile`` bucket),
the ``engine_first_dispatch_s{kind}`` gauge and the ``compile_begin`` /
``compile`` flight events.

:func:`make_multi_train_step` is the twin of ``make_multi_train_step``
(``:288-345``): k optimizer steps in one call, a loop on the CPU and one
replayed CUDA graph of the k steps on the card (:class:`_GraphedSteps`).

``dynamics_every`` > 0 adds the training-dynamics stats
(:class:`~..obs.dynamics.StepStats`, JAX ``cadence_stats``) to the
metrics of the optimizer steps that complete a multiple of it: the
gradients' norms and non-finite counts before the update, the parameters
copied before it and compared after it, all on the device.  JAX gates
them with ``lax.cond`` inside the compiled step; here the host knows the
step count, so a step off the cadence runs what a step without dynamics
runs, and the CUDA graphs of k steps are captured once per cadence
pattern of their k steps (the graph of a call with no cadence step is
the graph without dynamics).  A call of k steps that holds a cadence
step stacks the stats (k,), zeros off the cadence, as JAX's scan does.

Loss-function contract: ``loss_fn(batch, generator) -> (loss, metrics)``
with ``batch`` a dict of (B, ...) tensors, ``generator`` the
microbatch's :class:`~..models.layers.DropoutKey` (its seed, from
:func:`step_seed`, in device memory on the card), ``loss`` a scalar
tensor and ``metrics`` a dict of scalar tensors.  JAX's contract also
returns the new model state (``batch_stats``); here BatchNorm's running
statistics are module buffers that each training forward updates in
place, so the microbatches, run one after another, update them once each
in order, as the JAX scan threads ``model_state`` through them.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from .. import obs
from ..models.layers import DropoutKey
from ..obs import dynamics as dynlib
from ..ops import _cuda
from ..parallel import collectives
from ..parallel.mesh import replica_index
from .optimizers import schedule_rates
from .state import TrainState


def step_generator(seed: int, step: int, micro: int = 0,
                   rank: int = 0) -> torch.Generator:
    """A CPU generator for microbatch ``micro`` of step ``step`` on replica
    ``rank``: the port's ``fold_in(rng, step)`` followed by ``split``, a
    seed derived from ``(seed, step, micro)`` and, for ``rank`` > 0, the
    rank (JAX draws one dropout mask over the global batch, so each
    replica's rows get their own bits; replica 0 draws what one device
    draws)."""
    key = [seed, step, micro] + ([rank] if rank else [])
    state = np.random.SeedSequence(key).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state) >> 1)


def step_seed(seed: int, step: int, micro: int = 0, rank: int = 0) -> int:
    """The dropout seed of microbatch ``micro`` of step ``step`` on replica
    ``rank``: one draw from :func:`step_generator`.  Every dropout site of
    the microbatch's forward draws its mask from this seed and its own
    site index (:class:`~..models.layers.DropoutKey`)."""
    return int(torch.randint(2**62, (), generator=step_generator(
        seed, step, micro, rank)))


def dropout_keys(seed: int, step: int, accum_steps: int, rank: int = 0,
                 device=None) -> list[DropoutKey]:
    """One :class:`DropoutKey` per microbatch of step ``step``; on a CUDA
    ``device`` the seeds go to the card in one copy from pinned memory
    (no host sync)."""
    seeds = [step_seed(seed, step, i, rank) for i in range(accum_steps)]
    if device is None or torch.device(device).type != "cuda":
        return [DropoutKey(s) for s in seeds]
    table = torch.tensor(seeds, dtype=torch.int64).pin_memory().to(
        device, non_blocking=True)
    return [DropoutKey(table[i:i + 1]) for i in range(accum_steps)]


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def split_microbatches(batch: dict, accum_steps: int) -> list[dict]:
    """Each leaf (B, ...) cut into ``accum_steps`` (B // accum_steps, ...)
    microbatches."""
    for name, x in batch.items():
        if x.shape[0] % accum_steps:
            raise ValueError(f"batch dim {x.shape[0]} of {name!r} not "
                             f"divisible by accum_steps={accum_steps}")
    return [{k: x.chunk(accum_steps)[i] for k, x in batch.items()}
            for i in range(accum_steps)]


def _microbatch_grads(loss_fn, model, batch, keys, accum_steps):
    """``(names, grads, metrics)``: the parameters' names, their gradients
    summed over the microbatches, and each microbatch's metrics with its
    loss; microbatch ``i`` draws its dropout from ``keys[i]``."""
    names, params = zip(*model.named_parameters())
    grads, metrics = None, []
    for i, mb in enumerate(split_microbatches(batch, accum_steps)):
        loss, m = loss_fn(mb, keys[i])
        gs = torch.autograd.grad(loss, params, allow_unused=True,
                                 materialize_grads=True)
        grads = list(gs) if grads is None else \
            [a.add_(b) for a, b in zip(grads, gs)]
        metrics.append({k: v.detach() for k, v in dict(m, loss=loss).items()})
    return names, grads, metrics


def _average(names, grads, metrics, accum_steps):
    """The gradients and the microbatches' metrics, each summed and then
    divided by the count of microbatches, as the JAX scan does."""
    total = {}
    for m in metrics:
        for k, val in m.items():
            total[k] = val if k not in total else total[k] + val
    if accum_steps > 1:
        inv = 1.0 / accum_steps
        grads = [g.mul_(inv) for g in grads]
        total = {k: val * inv for k, val in total.items()}
    return dict(zip(names, grads)), total


def accumulate_gradients(loss_fn, model: torch.nn.Module, batch: dict, *,
                         seed: int, step: int, accum_steps: int = 1,
                         keys=None):
    """``(grads, metrics)``: gradients by parameter name and the metrics
    (with ``loss``), each summed over the microbatches and then divided
    by their count, as the JAX scan does.  ``keys``: the microbatches'
    dropout keys (default :func:`dropout_keys` of ``seed`` and ``step``)."""
    if keys is None:
        keys = dropout_keys(seed, step, accum_steps, 0, _device_of(model))
    return _average(*_microbatch_grads(loss_fn, model, batch, keys,
                                       accum_steps), accum_steps)


def _finalize(metrics: dict) -> dict:
    """Global metrics from summed shares: ``log_<name>`` becomes
    ``<name> = exp(sum)`` (perplexity is the exp of the global loss, not
    a sum of per-rank exps)."""
    return {(k[4:] if k.startswith("log_") else k):
            (torch.exp(v) if k.startswith("log_") else v)
            for k, v in metrics.items()}


def accumulate_gradients_dp(loss_fn, model: torch.nn.Module, batch: dict,
                            mesh, *, seed: int, step: int,
                            accum_steps: int = 1, keys=None, overlap=None,
                            zero=None):
    """:func:`accumulate_gradients` for one rank of a data-parallel mesh:
    the global ``(grads, metrics)`` of JAX's step on the global batch.

    ``batch`` holds this rank's share of each microbatch (the layout of
    :func:`..data.device_put_batch`) and ``loss_fn`` was built for the
    mesh: it returns this rank's *share* of the microbatch's loss and
    metrics, numerators over its rows and denominators over every rank's,
    so that the global value is the sum of the shares over the ranks
    (a ``log_<name>`` metric is the share of a log, see
    :func:`_finalize`).  The gradients of the shares, accumulated over the
    microbatches, and every microbatch's metric shares go through one
    :func:`..parallel.collectives.packed_all_reduce` (SUM, in packs of
    ``DEFAULT_BYTES_PER_PACK``) a step, after the last backward, as JAX
    sums the gradients once after its scan.
    Then both are averaged over the microbatches.  For a world of one the
    shares are the losses themselves and this is
    :func:`accumulate_gradients` bit for bit.

    With an ``overlap`` plan (``parallel.overlap.OverlapPlan``) each
    microbatch's backward syncs the gradients in buckets as they fill,
    and only the metrics take the all-reduce here; with a ``zero``
    sharder and no plan the gradients stay this rank's sums (the
    sharder's update reduce-scatters them).  The synced gradients of a
    plan with ``zero`` are this rank's rows."""
    if keys is None:
        keys = dropout_keys(seed, step, accum_steps, replica_index(mesh),
                            _device_of(model))
    if overlap is not None:
        names, grads, shares = overlap.grads(
            loss_fn, split_microbatches(batch, accum_steps), keys)
    else:
        names, grads, shares = _microbatch_grads(
            loss_fn, model, batch, keys, accum_steps)
    keys = list(shares[0])
    table = torch.stack([torch.stack([s[k].float() for k in keys])
                         for s in shares])  # (accum, metrics)
    if overlap is not None or zero is not None:
        table = collectives.all_reduce(table, mesh)
    else:
        *grads, table = collectives.packed_all_reduce(
            grads + [table], mesh,
            options=collectives.Options(collectives.DEFAULT_BYTES_PER_PACK))
    return _average(names, grads,
                    [_finalize(dict(zip(keys, row))) for row in table],
                    accum_steps)


class _InstrumentedStep:
    """Thin telemetry shim over a step function: counts dispatches into
    the registry and records the first one (its wall time, flight markers
    and ``compile_<label>`` span) without touching the later dispatches
    beyond one counter increment."""

    __slots__ = ("_fn", "_label", "_first", "_dispatches", "_first_gauge")

    def __init__(self, fn, label: str):
        self._fn = fn
        self._label = label
        self._first = True
        self._dispatches = obs.counter(
            "engine_dispatches_total",
            "train/eval step dispatches by executable kind",
        )
        self._first_gauge = obs.gauge(
            "engine_first_dispatch_s",
            "wall seconds of the first dispatch (kernel loads + run)",
        )

    def reset(self) -> None:
        """Forget the step's captured state (the wrapped step's
        ``reset``, where it has one): after a cold re-initialisation."""
        reset = getattr(self._fn, "reset", None)
        if reset is not None:
            reset()

    def __call__(self, *args):
        if self._first:
            self._first = False
            # the begin marker lands BEFORE the call that may wedge: a ring
            # ending in compile_begin names a hang in the first dispatch
            obs.record_event("compile_begin", label=self._label)
            with obs.span(f"compile_{self._label}"):
                t0 = time.perf_counter()
                out = self._fn(*args)
                dur = time.perf_counter() - t0
                self._first_gauge.set(dur, kind=self._label)
            obs.record_event("compile", label=self._label,
                             seconds=round(dur, 3))
            self._dispatches.inc(kind=self._label)
            return out
        self._dispatches.inc(kind=self._label)
        return self._fn(*args)


def _apply(state: TrainState, grads: dict, rows: bool = False
           ) -> TrainState:
    """The update: the overlapped sync of a ZeRO state (or ``rows``, the
    sharder's own reduce-scatter) has left this rank's summed rows, which
    go to the sharder as they are."""
    if state.zero is not None and (rows or state.overlap is not None):
        return state.zero.apply_gradients(state, grads, reduced=True)
    return state.apply_gradients(grads)


def _train_one(loss_fn, state: TrainState, batch: dict, keys, *,
               accum_steps: int, seed: int, mesh, stats=None):
    """One optimizer step of ``state`` on ``batch``: the body of the
    single step and of every step of a multi-step call.  With ``stats``
    (a :class:`~..obs.dynamics.StepStats`: the step is on the dynamics
    cadence) the metrics carry the ``dynamics/`` keys, computed from the
    global gradients (after a mesh's gradient sum; under ZeRO this rank's
    summed rows, the reduce-scatter run first), so that every rank holds
    the same values."""
    if mesh is None:
        grads, metrics = accumulate_gradients(
            loss_fn, state.model, batch, seed=seed, step=state.step,
            accum_steps=accum_steps, keys=keys)
    else:
        grads, metrics = accumulate_gradients_dp(
            loss_fn, state.model, batch, mesh, seed=seed, step=state.step,
            accum_steps=accum_steps, keys=keys, overlap=state.overlap,
            zero=state.zero)
    if stats is None:
        return _apply(state, grads), metrics
    rows = state.zero is not None
    if rows and state.overlap is None:
        grads = state.zero.reduce_rows(grads)
    # the optimizer clips the gradients and updates the parameters in
    # place: read the one and copy the other first
    dyn, old = stats.before(state.model, grads)
    state = _apply(state, grads, rows)
    return state, dict(metrics, **stats.after(state.model, dyn, old))


class _Cadence:
    """A train step's dynamics cadence: which optimizer steps carry the
    stats (every ``every``-th completed one; 0 = none) and the
    :class:`~..obs.dynamics.StepStats` that computes them, grouped by
    ``modules`` (parameter name -> top-level module, default the name's
    first component), made at the first cadence step."""

    def __init__(self, every: int, modules=None):
        if every < 0:
            raise ValueError(f"dynamics_every must be >= 0, got {every}")
        self.every, self.modules, self._stats = every, modules, None

    def stats(self, state: TrainState):
        """The stats of the step ``state`` is about to take, or None when
        it is off the cadence."""
        if not dynlib.on_cadence(state.step, self.every):
            return None
        if self._stats is None:
            self._stats = dynlib.StepStats(
                [n for n, _ in state.model.named_parameters()],
                self.modules, dynlib.stat_split(state))
        return self._stats

    def mask(self, step: int, k: int) -> tuple[bool, ...]:
        """Which of the k steps from ``step`` are on the cadence."""
        return tuple(dynlib.on_cadence(step + i, self.every)
                     for i in range(k))


def make_train_step(loss_fn, *, accum_steps: int = 1, seed: int = 0,
                    mesh=None, dynamics_every: int = 0,
                    dynamics_modules=None):
    """``step(state, batch) -> (state, metrics)``: gradients of
    ``loss_fn`` averaged over ``accum_steps`` microbatches, then one
    update of ``state`` (in place).  With a ``mesh`` the step is one
    rank's of the data-parallel step (:func:`accumulate_gradients_dp`;
    ``loss_fn`` built for the mesh) and every rank applies the same
    global gradients (a ZeRO state: its rows of them; a state with an
    ``overlap`` plan syncs them in buckets during the backward).
    ``dynamics_every`` > 0: the steps that complete a
    multiple of it add the ``dynamics/`` stats to their metrics, grouped
    by ``dynamics_modules`` (``models.flax_modules``)."""
    cadence = _Cadence(dynamics_every, dynamics_modules)

    def step(state: TrainState, batch: dict):
        return _train_one(loss_fn, state, batch, None,
                          accum_steps=accum_steps, seed=seed, mesh=mesh,
                          stats=cadence.stats(state))

    return _InstrumentedStep(step, "train_step")


def _metric_names(metrics: list[dict]) -> list[str]:
    """Every key of the steps' metrics, in the order they first appear
    (a cadence step has the ``dynamics/`` keys, the others do not)."""
    return list(dict.fromkeys(k for m in metrics for k in m))


def _stack_metrics(metrics: list[dict]) -> dict:
    """The steps' metrics stacked (k,), a key a step lacks as 0 there."""
    out = {}
    for k in _metric_names(metrics):
        like = next(m[k] for m in metrics if k in m)
        out[k] = torch.stack([m[k] if k in m else torch.zeros_like(like)
                              for m in metrics])
    return out


class _GraphedSteps:
    """``k`` optimizer steps a call, ``call(state, bundle) -> (state,
    metrics)`` with ``bundle`` leaves (k', B, ...) for k' <= k and the
    metrics stacked (k',).

    A CPU state runs k' single steps in a loop.  A CUDA state runs its
    first call's k' steps eagerly (real steps: the kernels load, cuBLAS
    and NCCL start, the optimizer makes its moments, the allocator
    fills), under ``torch.cuda.set_sync_debug_mode("error")``, so a step
    that reads the card on the host fails there, by name; then it
    captures a CUDA graph of k' steps (a capture runs nothing).  Every
    later call replays the graph of its k' steps, captured at its first
    use if the first call did not (a short tail's graph shares the first
    one's memory pool).  Before a replay the host copies the bundle into
    the graph's static (k, B, ...) inputs, the k' steps' dropout seeds
    (:func:`step_seed`, drawn on the host as the single step draws them)
    and learning rates (the optimizer's :class:`~.optimizers.RateTable`)
    into theirs; after it, ``state.step`` and the schedule count advance
    by k' on the host and the call returns a fresh copy of the graph's
    metrics table (the next replay overwrites the table, and the Trainer
    reads metrics only at log steps).  A graph is captured again when
    the state's tensors are no longer the ones it captured (a restore
    that replaced the optimizer's moments).  A capture that fails
    raises: there is no eager fallback on the card.

    With a dynamics cadence the graphs are keyed by k' and the cadence
    pattern of the call's k' steps (``_Cadence.mask``): a call whose
    steps hold a cadence step replays a graph that computes the stats at
    those steps, every other call the graph without them.

    The graph captures the launches the eager steps make, so its steps
    compute the single step's bits.  ``ops._cuda.launches`` counts what
    the capture counted once a replay (``captured_launches``).  The
    data-parallel step's packed all-reduce is captured under NCCL; gloo
    moves CUDA tensors through the host, which a graph cannot hold, so a
    gloo group over CUDA tensors raises, and so does a state with a
    ZeRO sharder or an overlap plan (not ported under a graph)."""

    def __init__(self, loss_fn, steps_per_call, accum_steps, seed, mesh,
                 cadence: _Cadence):
        self.k = steps_per_call
        self.loss_fn, self.accum, self.seed, self.mesh = (
            loss_fn, accum_steps, seed, mesh)
        self.cadence = cadence
        self.rank = 0 if mesh is None else replica_index(mesh)
        self._warm = False
        self._graphs: dict[tuple, tuple] = {}
        self._pool = None
        self._inputs: dict[str, torch.Tensor] | None = None
        self._seeds: torch.Tensor | None = None
        self._captured_on = None

    def _one(self, state, batch, keys=None):
        return _train_one(self.loss_fn, state, batch, keys,
                          accum_steps=self.accum, seed=self.seed,
                          mesh=self.mesh, stats=self.cadence.stats(state))

    def _loop(self, state, bundle, k):
        metrics = []
        for i in range(k):
            state, m = self._one(state, {n: x[i] for n, x in bundle.items()})
            metrics.append(m)
        return state, _stack_metrics(metrics)

    def __call__(self, state: TrainState, bundle: dict):
        k = next(iter(bundle.values())).shape[0]
        if not 0 < k <= self.k:
            raise ValueError(f"a bundle of {k} steps for steps_per_call="
                             f"{self.k}")
        device = _device_of(state.model)
        if device.type != "cuda":
            return self._loop(state, bundle, k)
        group = collectives.resolve_group(self.mesh)
        if group is not None and group.name() != "nccl":
            raise RuntimeError(
                f"steps_per_call > 1 on CUDA tensors needs an NCCL process "
                f"group, got {group.name()}: a CUDA graph cannot capture "
                f"collectives that move tensors through the host")
        if state.zero is not None or state.overlap is not None:
            raise NotImplementedError(
                "steps_per_call > 1 with ZeRO or the bucketed overlap is not "
                "ported on CUDA: no run has captured their collectives and "
                "host-side hooks in a CUDA graph (ROADMAP.md)")
        if not self._warm:
            previous = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = self._loop(state, bundle, k)
            finally:
                torch.cuda.set_sync_debug_mode(previous)
            self._warm = True
            self._capture(state, bundle, k, device)
            return out
        if self._captured_on != self._addresses(state):
            self._graphs.clear()
            self._pool = None
        key = (k, self.cadence.mask(state.step, k))
        if key not in self._graphs:
            self._capture(state, bundle, k, device)
        graph, table, keys, counts = self._graphs[key]
        self._fill(state, bundle, k, device)
        graph.replay()
        counts.replayed()
        state.advance(k)
        table = table.clone()
        return state, {name: table[:, j] for j, name in enumerate(keys)}

    def reset(self) -> None:
        """Drop the graphs: the next call runs its steps eagerly again and
        captures anew (a state re-initialised in place has no optimizer
        moments until its first eager step makes them)."""
        self._warm = False
        self._graphs.clear()
        self._pool = None
        self._captured_on = None

    def _addresses(self, state) -> tuple:
        """Where the state's tensors live: a graph reads and writes these
        addresses, so a state that moved is captured again."""
        opt = state.optimizer
        tensors = [*state.model.parameters(), *state.model.buffers()]
        tensors += [v for st in opt.state.values() for v in st.values()
                    if torch.is_tensor(v)]
        rates = getattr(opt, "rates", None)
        if rates is not None:
            tensors.append(rates.table)
        return tuple(t.data_ptr() for t in tensors)

    def _fill(self, state, bundle, k, device):
        """The replay's inputs into the graph's static buffers, each one
        copy that does not block the host."""
        for name, x in bundle.items():
            want = self._inputs[name]
            if x.shape[1:] != want.shape[1:] or x.dtype != want.dtype:
                raise ValueError(
                    f"bundle leaf {name!r} is {tuple(x.shape[1:])} "
                    f"{x.dtype} a step, the captured steps take "
                    f"{tuple(want.shape[1:])} {want.dtype}")
            if x.device.type == "cpu":
                x = x.pin_memory()
            want[:k].copy_(x, non_blocking=True)
        seeds = [[step_seed(self.seed, state.step + i, a, self.rank)
                  for a in range(self.accum)] for i in range(k)]
        host = torch.tensor(seeds, dtype=torch.int64).pin_memory()
        self._seeds[:k].copy_(host, non_blocking=True)
        opt = state.optimizer
        rates = schedule_rates(opt, k)
        if rates is not None and getattr(opt, "rates", None) is not None:
            opt.rates.fill(rates)

    def _capture(self, state, bundle, k, device):
        opt = state.optimizer
        table = getattr(opt, "rates", None)
        if self._inputs is None:
            # every graph of this call reads these buffers; made once, at
            # the full k, before the first capture
            self._inputs = {n: torch.empty((self.k, *x.shape[1:]),
                                           dtype=x.dtype, device=device)
                            for n, x in bundle.items()}
            self._seeds = torch.zeros((self.k, self.accum), dtype=torch.int64,
                                      device=device)
            if table is not None:
                table.reserve(self.k)
        step0 = state.step
        key = (k, self.cadence.mask(step0, k))
        counts0 = [g.get("count") for g in opt.param_groups]
        graph = torch.cuda.CUDAGraph()
        metrics = []
        # no garbage collection inside the capture: an unreachable graph
        # (an earlier run's, held by a reference cycle) freed there would
        # release its memory pool with CUDA calls that end the capture
        gc.collect()
        gc_was_enabled = gc.isenabled()
        gc.disable()
        try:
            with _cuda.captured_launches() as counts, \
                    torch.cuda.graph(graph, pool=self._pool,
                                     # the Prefetcher's thread copies on
                                     capture_error_mode="thread_local"), \
                    (table.capturing() if table is not None
                     else contextlib.nullcontext()):
                for i in range(k):
                    keys = [DropoutKey(self._seeds[i, a:a + 1])
                            for a in range(self.accum)]
                    state, m = self._one(
                        state, {n: x[i] for n, x in self._inputs.items()},
                        keys)
                    metrics.append(m)
                names = _metric_names(metrics)
                stacked = _stack_metrics(metrics)
                out = torch.stack([stacked[n].float() for n in names], 1)
        finally:
            if gc_was_enabled:
                gc.enable()
            # the capture ran nothing: the host's record of the steps goes
            # back to where it was
            state.step = step0
            for group, count in zip(opt.param_groups, counts0):
                if count is not None:
                    group["count"] = count
        self._pool = graph.pool()
        self._graphs[key] = (graph, out, names, counts)
        self._captured_on = self._addresses(state)


def make_multi_train_step(loss_fn, *, steps_per_call: int,
                          accum_steps: int = 1, seed: int = 0, mesh=None,
                          dynamics_every: int = 0, dynamics_modules=None):
    """``steps_per_call`` optimizer steps in one call (:class:`_GraphedSteps`):
    the bundle's leaves are (k, B, ...), one batch a step, and the
    metrics come back stacked (k,).  The steps follow the single step's
    trajectory exactly: the same dropout seeds (step, microbatch, rank)
    and learning rates, and the same ``dynamics/`` stats at the same
    steps (:func:`make_train_step`).  ``steps_per_call <= 1`` is
    :func:`make_train_step` (the reference's ``:302-307``)."""
    if steps_per_call <= 1:
        return make_train_step(loss_fn, accum_steps=accum_steps, seed=seed,
                               mesh=mesh, dynamics_every=dynamics_every,
                               dynamics_modules=dynamics_modules)
    return _InstrumentedStep(
        _GraphedSteps(loss_fn, steps_per_call, accum_steps, seed, mesh,
                      _Cadence(dynamics_every, dynamics_modules)),
        "multi_train_step")


def make_eval_step(metric_fn, mesh=None):
    """``eval_step(state, batch) -> metrics`` for a ``metric_fn(batch)``
    over the state's model (the eval functions run without autograd).

    With a ``mesh``, ``metric_fn`` was built for it (the workloads'
    ``eval_fn(model, group=mesh)``): ``batch`` is this rank's share of the
    global eval batch and ``metric_fn`` returns this rank's shares of the
    global means, numerators over its rows and denominators over every
    rank's, as the train step's losses are.  One all-reduce a batch sums
    the shares, and ``log_<name>`` becomes ``<name> = exp(sum)``, so the
    metrics are those of JAX's eval step on the global batch."""

    def eval_step(state: TrainState, batch: dict):
        metrics = metric_fn(batch)
        if mesh is None:
            return metrics
        keys = list(metrics)
        table = collectives.all_reduce(
            torch.stack([metrics[k].float() for k in keys]), mesh)
        return _finalize(dict(zip(keys, table)))

    return _InstrumentedStep(eval_step, "eval_step")
