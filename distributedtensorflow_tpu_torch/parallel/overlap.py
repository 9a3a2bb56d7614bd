"""Bucketed gradient sync that overlaps the backward pass.

Twin of ``distributedtensorflow_tpu/parallel/overlap.py``.  The
data-parallel step sums the gradients once, after the last backward
(``train.engine.accumulate_gradients_dp``), so the links idle through the
backward and the backward waits for nothing.  With a plan, each bucket's
collective starts as soon as the backward has produced the bucket's last
gradient: a hook on each parameter (``Tensor.register_hook``, which
``torch.autograd.grad`` runs on the gradient it returns) counts the
bucket's gradients, and the full bucket goes out as one async all-reduce
of its flattened gradients (a reduce-scatter of their chunked views
under ZeRO, ``parallel.zero``), while the backward goes on to the layers
below.  The handles are waited on before the update.  (A
``register_post_accumulate_grad_hook`` needs ``.backward()``, which
sums the tied embedding's two gradients in another order than
``autograd.grad``: the step would no longer be the plain step's bits.)

Buckets (:func:`plan_buckets`) group the parameters by their top-level
module (``h0`` ... ``h11``, ``wte``: the first component of the flax
path, ``models.flax_paths``), in the JAX tree's order, and merge
adjacent small groups up to ``bucket_bytes``; every parameter lands in
exactly one bucket, the reference's.  A bucket
holds one dtype (a flat buffer cannot mix them).

The hooks count only the engine's backward (``torch.autograd.grad`` of
a microbatch's loss), never a backward that the loss's forward runs
itself.  The pipelined GPT (``models.gpt_pipeline``) runs every
microbatch's backward by hand inside its loss's forward and banks the
parameters' gradients, which the loss's backward then hands out at once;
so a plan built for such a model (one with a ``grad_ready`` slot) is its
sink instead: the schedule hands a stage chunk's banked gradients to
:meth:`OverlapPlan.ready` as soon as the chunk's last microbatch has run
its backward unit, and its buckets go out while the schedule's later
ticks run (``describe()["pipe"]`` is ``"schedule"``).  The table and
``ln_f``, summed over ``pipe`` at the schedule's end, come through the
hooks.

Over ``seq`` the plain sync is an all-reduce over the mesh's ``group``
(``data`` x ``fsdp`` x ``seq``), as the unbucketed step's; under ZeRO the
sharder's (``seq_group`` first, then the reduce-scatter over the batch
group).  Over ``expert`` and ``pipe`` the ``group`` is the batch group.

Each microbatch's gradients are synced on their own, as JAX's tag fires
once a microbatch: ``accum_steps`` > 1 moves ``accum_steps`` times the
bytes.  Sums of two ranks are exact, so at a world of 2 the bucketed
step equals the unbucketed one bit for bit.  Not DDP: DDP syncs every
microbatch unless told otherwise, and refuses a bare gloo group a
thread.  Each bucket's dispatch is recorded in the registry's
``collective_dispatch_seconds{op, overlapped="1"}``.
"""

from __future__ import annotations

import time
from typing import Sequence

import torch

from .. import obs
from . import collectives

__all__ = ["OverlapPlan", "plan_buckets"]

def _dispatch_histogram():
    """The registry's ``collective_dispatch_seconds`` (looked up at each
    use: a run may install another default registry)."""
    return obs.histogram(
        "collective_dispatch_seconds",
        "host seconds to dispatch one collective (an async one returns at "
        "once)")


def plan_buckets(leaves: Sequence[tuple[str, tuple[int, ...], torch.dtype]],
                 bucket_bytes: int) -> list[list[int]]:
    """Buckets of leaf indices from ``(group key, shape, dtype)`` leaves
    in order: a group's leaves are never split; adjacent groups merge
    while the running size stays within ``bucket_bytes`` (JAX's
    ``plan_buckets``), and a dtype change starts a new bucket."""
    groups: list[tuple[str, list[int], int, torch.dtype]] = []
    for i, (key, shape, dtype) in enumerate(leaves):
        size = 1
        for d in shape:
            size *= d
        nbytes = size * torch.empty((), dtype=dtype).element_size()
        if groups and groups[-1][0] == key:
            k, idxs, b, dt = groups[-1]
            groups[-1] = (k, idxs + [i], b + nbytes, dt)
        else:
            groups.append((key, [i], nbytes, dtype))
    buckets: list[list[int]] = []
    cur: list[int] = []
    cur_bytes, cur_dtype = 0, None
    for _, idxs, nbytes, dtype in groups:
        if cur and (cur_bytes + nbytes > bucket_bytes or dtype != cur_dtype):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.extend(idxs)
        cur_bytes += nbytes
        cur_dtype = dtype
    if cur:
        buckets.append(cur)
    return buckets


class OverlapPlan:
    """The bucketed sync of one model's gradients over a batch group.

    :meth:`build` plans the buckets and registers the hooks;
    :meth:`grads` runs the microbatches' backward passes and returns the
    synced gradients: whole sums over the group, or with ``zero`` (a
    ``ZeroSharder``) this rank's summed rows.  The hooks count only
    inside :meth:`grads`'s ``torch.autograd.grad``, :meth:`ready` only
    while a microbatch runs."""

    def __init__(self, model: torch.nn.Module, buckets, group, *,
                 zero=None):
        self.names, self.params = map(list, zip(*model.named_parameters()))
        self.buckets = [list(b) for b in buckets]
        covered = sorted(i for b in self.buckets for i in b)
        if covered != list(range(len(self.params))):
            raise ValueError(f"buckets cover {len(covered)} parameter slots "
                             f"of {len(self.params)} (or one twice)")
        self.group, self.zero = group, zero
        #: share of the parameter bytes whose sync the backward issues
        self.coverage = 1.0
        self._bucket_of = {i: b for b, idxs in enumerate(self.buckets)
                           for i in idxs}
        self._active = False
        self._collecting = False
        self._index = {id(p): i for i, p in enumerate(self.params)}
        #: "schedule" when a pipelined model hands its banked gradients to
        #: :meth:`ready` (see the module docstring), else None
        self.pipe = None
        self._pending: list[int] = []
        self._grads: list = []
        self._inflight: dict[int, tuple] = {}
        self._handles = [p.register_hook(self._hook(i))
                         for i, p in enumerate(self.params)]

    @classmethod
    def build(cls, model, mesh, *, zero=None, paths=None,
              bucket_bytes: int = 4 << 20) -> "OverlapPlan":
        """The plan for ``model`` over ``mesh``'s batch group.  ``paths``
        maps a parameter name to its flax path (``models.flax_paths``):
        the parameters are then bucketed in the JAX tree's order (its
        keys sorted) by their top-level module, so each bucket holds the
        parameters of the reference's bucket; without, in the model's
        order by the name's first component."""
        names = [n for n, _ in model.named_parameters()]
        paths = paths or {n: tuple(n.split(".")) for n in names}
        order = sorted(range(len(names)), key=lambda i: paths[names[i]])
        params = dict(model.named_parameters())
        leaves = [(paths[names[i]][0], tuple(params[names[i]].shape),
                   params[names[i]].dtype) for i in order]
        buckets = [[order[j] for j in b]
                   for b in plan_buckets(leaves, bucket_bytes)]
        plan = cls(model, buckets, mesh.group, zero=zero)
        if hasattr(model, "grad_ready"):
            model.grad_ready = plan.ready
            plan.pipe = "schedule"
        return plan

    def remove(self) -> None:
        for h in self._handles:
            h.remove()

    def describe(self) -> dict:
        out = {"buckets": len(self.buckets), "coverage": self.coverage,
               "mode": "reduce_scatter" if self.zero is not None
               else "all_reduce"}
        if self.pipe is not None:
            out["pipe"] = self.pipe
        return out

    # --- the backward hooks ---------------------------------------------------

    def _take(self, i: int, grad) -> None:
        """Parameter ``i``'s gradient of this microbatch: counted once
        (the pipelined loss's backward hands out again what the schedule
        gave :meth:`ready`), its bucket launched when it is the last."""
        if self._grads[i] is not None:
            return
        self._grads[i] = grad
        b = self._bucket_of[i]
        self._pending[b] -= 1
        if self._pending[b] == 0:
            self._launch(b)

    def _hook(self, i: int):
        def hook(grad):
            if self._active:
                self._take(i, grad)
        return hook

    def ready(self, params, grads) -> None:
        """A pipelined model's banked gradients ``grads`` of its tensors
        ``params``, whole for this microbatch of the engine: each counted
        as a hook would count it (nothing outside :meth:`grads`)."""
        if not self._collecting:
            return
        for p, g in zip(params, grads):
            self._take(self._index[id(p)], g)

    def _launch(self, b: int) -> None:
        grads = [self._grads[i] for i in self.buckets[b]]
        t0 = time.perf_counter()
        if self.zero is not None:
            flat, work = self.zero.reduce_scatter_grads(grads)
            op = "reduce_scatter"
        else:
            flat = torch.cat([g.reshape(-1) for g in grads])
            work = collectives.all_reduce_async(flat, self.group)
            op = "all_reduce"
        _dispatch_histogram().observe(time.perf_counter() - t0, op=op,
                                      overlapped="1")
        self._inflight[b] = (flat, work)

    def _finish(self, grads) -> list[torch.Tensor]:
        """Launch the buckets the backward left (parameters it never
        reached: ``grads``, the backward's, holds their zeros), wait for
        all, and return the synced gradients by parameter (ZeRO: rows)."""
        for b, idxs in enumerate(self.buckets):
            if b not in self._inflight:
                for i in idxs:
                    self._grads[i] = grads[i]
                self._launch(b)
        out: list = [None] * len(self.params)
        for b, (flat, work) in sorted(self._inflight.items()):
            if work is not None:
                work.wait()
            idxs = self.buckets[b]
            if self.zero is not None:
                for i, row in zip(idxs, self.zero.split_rows(flat, idxs)):
                    out[i] = row
                continue
            offset = 0
            for i in idxs:
                n = self.params[i].numel()
                out[i] = flat[offset:offset + n].view(self.params[i].shape)
                offset += n
        self._inflight.clear()
        return out

    def grads(self, loss_fn, batches, keys):
        """``(names, grads, metrics)`` of the microbatches ``batches``
        (microbatch ``i`` draws its dropout from ``keys[i]``): each
        microbatch's backward syncs the buckets as they fill; the synced
        gradients are summed over the microbatches."""
        total, metrics = None, []
        try:
            for i, mb in enumerate(batches):
                self._pending = [len(b) for b in self.buckets]
                self._grads = [None] * len(self.params)
                self._collecting = True
                loss, m = loss_fn(mb, keys[i])
                self._active = True
                gs = torch.autograd.grad(loss, self.params, allow_unused=True,
                                         materialize_grads=True)
                self._active = self._collecting = False
                synced = self._finish(gs)
                total = synced if total is None else \
                    [a + b for a, b in zip(total, synced)]
                metrics.append({k: v.detach()
                                for k, v in dict(m, loss=loss).items()})
        finally:
            self._active = self._collecting = False
            self._grads = []
        return self.names, total, metrics
