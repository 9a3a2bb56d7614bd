"""Rotating, asynchronous checkpoints with integrity manifests.

Twin of ``distributedtensorflow_tpu/checkpoint/manager.py`` (``:71-346``).
JAX saves through Orbax; the port keeps Orbax's step semantics on disk
without it:

- ``<dir>/<step>/state.pt`` holds the state, ``torch.save`` of CPU
  tensors and plain values, read back with ``torch.load(...,
  weights_only=True)``.  The step directory is written under a temporary
  name (``<dir>/.tmp-<step>-<pid>``) and renamed into place; then the
  commit marker ``_CHECKPOINT_METADATA`` (the step, the time and the
  save's metrics) is written, last.  A step directory without it is not a
  step (:meth:`CheckpointManager.all_steps`).
- What is saved is JAX's ``_as_tree`` (:func:`as_tree`): ``step``, the
  model's parameters (``params``), its buffers (``model_state``: the
  BatchNorm statistics) and the optimizer's ``state_dict``
  (``opt_state``: the moments, and optax's ``count`` in the parameter
  groups).
- A restore copies into the target state's own tensors on their device
  (``load_state_dict``, which ``copy_``'s) and then loads the optimizer's
  state, so the target keeps its tensors, hooks and schedule.
- An asynchronous save blocks only while the state is copied to the host
  into pinned buffers that are reused from save to save; it returns when
  that copy is complete, so the training step that follows may update
  the parameters in place without tearing the checkpoint.  A writer
  thread then computes the checksums, writes the files and commits.  A
  new save first waits for one still in flight, and a failed write
  raises in the caller's thread at the next :meth:`~CheckpointManager.save`
  or :meth:`~CheckpointManager.wait`.
- Over a data-parallel mesh the state is replicated: the chief (rank 0
  of the mesh's group, or of the default group) alone copies and writes;
  every rank restores from the same files and verifies them against the
  manifest itself.  A forced save ends with the chief's commit and a
  barrier, so no rank reads a step that is not there yet.  A state split
  over ``model``, ``expert`` or ``pipe`` (``parallel.placement``) is put
  together whole on every rank before the chief's copy, so its step is
  the one a single process writes for the same state; a restore cuts
  each rank's pieces from the verified whole and checks them against the
  rank's own state.  Such a manager spans the whole world (``mesh``: the
  mesh's ``world``), not the batch group.

Telemetry (``obs``), as in JAX: the counters ``checkpoint_saves_total``,
``checkpoint_restores_total`` and ``checkpoint_verify_failures_total``,
the gauge ``checkpoint_last_save_blocking_s`` (the blocking part of a
save: the copy to the host, and for a forced save the commit), the spans
``checkpoint_save``, ``checkpoint_restore`` and ``checkpoint_wait`` (which
the goodput ledger books), the flight events ``checkpoint_begin``,
``checkpoint_end`` and ``checkpoint_corrupt``, and the goodput ledger's
lost-work anchor (``note_checkpoint``) and resume point
(``note_restore``).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
from collections.abc import Mapping

import torch

from .. import obs
from ..parallel import collectives
from ..parallel import zero as zero_lib
from . import integrity
from .integrity import CheckpointCorruptError

logger = logging.getLogger(__name__)

# Registry metrics: checkpoint IO health.  The save gauge records the
# BLOCKING part only: with async_save the write continues in the
# background and the train loop is already running again.
_M_SAVES = obs.counter("checkpoint_saves_total", "checkpoint saves accepted")
_M_RESTORES = obs.counter("checkpoint_restores_total", "checkpoint restores")
_M_SAVE_S = obs.gauge(
    "checkpoint_last_save_blocking_s", "blocking seconds of the last save call"
)
_M_VERIFY_FAILURES = obs.counter(
    "checkpoint_verify_failures_total",
    "checkpoints rejected at restore (truncated, corrupt, or checksum "
    "mismatch) before falling back to an older verified step",
)

#: File of a step's state and its commit marker (Orbax's name).
PAYLOAD = "state.pt"
COMMIT_MARKER = "_CHECKPOINT_METADATA"


def as_tree(state) -> dict:
    """What a checkpoint holds of a ``TrainState``: ``step``, ``params``,
    ``model_state`` (the buffers) and ``opt_state``; the tensors are the
    state's own (no copy).  A ZeRO state's optimizer slots are gathered
    to their ``(degree, chunk)`` views (a collective: every rank of the
    batch group calls this).  A state split over ``model``, ``expert`` or
    ``pipe`` is put together whole (``parallel.placement``: collectives
    over those groups), as one process holds it."""
    placement = getattr(state, "placement", None)
    if placement is not None:
        return placement.gather_tree(state)
    sd = state.model.state_dict()
    names = {n for n, _ in state.model.named_parameters(
        remove_duplicate=False)}
    opt = state.optimizer.state_dict()
    zero = getattr(state, "zero", None)
    if zero is not None:
        opt = zero.gather_opt_state(opt, state.optimizer)
    return {"step": int(state.step),
            "params": {k: v for k, v in sd.items() if k in names},
            "model_state": {k: v for k, v in sd.items() if k not in names},
            "opt_state": opt}


def _collective(state) -> bool:
    """Whether :func:`as_tree` of ``state`` runs collectives (every rank
    calls it, not the chief alone)."""
    return getattr(state, "zero", None) is not None or \
        getattr(state, "placement", None) is not None


def group_max(value: int, mesh=None) -> int:
    """The largest ``value`` over the ranks of ``mesh``'s group (a group,
    a mesh or None for the default group): one all-reduce of an int, a
    CUDA tensor on NCCL and a CPU tensor on gloo.  ``value`` itself for a
    world of one."""
    group = collectives.resolve_group(mesh)
    if group is None or group.size() == 1:
        return int(value)
    device = torch.device("cuda", torch.cuda.current_device()) \
        if group.name() == "nccl" else torch.device("cpu")
    flag = torch.tensor([int(value)], dtype=torch.int32, device=device)
    return int(collectives.all_reduce(flag, group,
                                      collectives.ReduceOp.MAX)[0])


def _check_geometry(tree: dict, target) -> dict:
    """The model's saved tensors, after checking that ``tree`` restores
    into ``target`` as it is (names, shapes, dtypes; the optimizer's
    groups); raises ValueError before anything of the target changes."""
    saved = {**tree["params"], **tree["model_state"]}
    own = target.model.state_dict()
    if saved.keys() != own.keys():
        raise ValueError(
            f"state names differ: missing {sorted(own.keys() - saved)[:5]}, "
            f"unexpected {sorted(saved.keys() - own)[:5]}")
    for k, t in own.items():
        if saved[k].shape != t.shape or saved[k].dtype != t.dtype:
            raise ValueError(f"{k}: geometry changed ({tuple(saved[k].shape)}"
                             f"/{saved[k].dtype} -> {tuple(t.shape)}/"
                             f"{t.dtype})")
    groups = tree["opt_state"]["param_groups"]
    sizes = [len(g["params"]) for g in groups]
    want = [len(g["params"]) for g in target.optimizer.param_groups]
    if sizes != want:
        raise ValueError(f"optimizer groups of {sizes} parameters, the "
                         f"target has {want}")
    return saved


class CheckpointManager:
    """Rotating, asynchronous checkpoint manager."""

    def __init__(
        self,
        directory: str,
        *,
        max_to_keep: int | None = 3,
        async_save: bool = True,
        save_interval_steps: int = 1,
        best_metric: str | None = None,
        best_mode: str = "max",
        integrity_manifest: bool = True,
        mesh=None,
    ):
        """``best_metric`` switches retention from keep-latest to
        keep-best: rotation keeps the ``max_to_keep`` steps with the best
        value of that metric (pass ``metrics`` to :meth:`save`),
        ``best_mode`` "max" or "min".  ``integrity_manifest=False`` skips
        the checksum manifest (one pass over the state a save); restores
        are then guarded only by the load raising.  ``mesh``: the mesh
        or process group whose chief writes (default: the default group
        when ``torch.distributed`` is initialised, else this process)."""
        if best_mode not in ("max", "min"):
            raise ValueError(f"best_mode must be 'max' or 'min', got "
                             f"{best_mode!r}")
        self._directory = str(directory)
        os.makedirs(self._directory, exist_ok=True)
        self._max_to_keep = max_to_keep
        self._async = async_save
        self._interval = max(1, int(save_interval_steps))
        self._best_metric = best_metric
        self._best_mode = best_mode
        self._integrity = integrity_manifest
        self._mesh = mesh
        #: Set by :meth:`restore_latest`: ``{"restored_step": int | None,
        #: "rejected": [{"step", "reason"}, ...]}``.
        self.last_restore_report: dict | None = None
        #: Steps this manager accepted a save of (every rank keeps the same
        #: record, so the ranks agree on a save without reading the disk).
        self._saved: set[int] = set()
        self._buffers: dict[str, torch.Tensor] = {}
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def set_mesh(self, mesh) -> None:
        """The mesh or process group whose chief writes and whose ranks
        agree on a forced save (``train_torch`` passes the mesh's
        ``world``: every rank of a split model takes part in a save)."""
        self._mesh = mesh

    @property
    def best_metric(self) -> str | None:
        """The keep-best retention metric (None: keep the latest)."""
        return self._best_metric

    @property
    def best_mode(self) -> str:
        return self._best_mode

    def _is_chief(self) -> bool:
        return collectives.group_rank(self._mesh) == 0

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._directory, str(int(step)))

    # ------------------------------------------------------------- saving

    def save(self, step: int, state, *, force: bool = False,
             metrics: dict | None = None) -> bool:
        """Save ``state`` as ``step``; False when the step was saved
        already or is off the save interval (``force`` saves anyway).
        Returns once the state is on the host; the files are written in
        the background unless ``async_save`` is False."""
        if self._thread is not None and not self._thread.is_alive():
            self.wait()  # raises the failure of the last write, if any
        step = int(step)
        done = step in self._saved or step in self.all_steps()
        if force and collectives.group_size(self._mesh) > 1:
            # every rank reads the directory before the chief can write
            # the step there, and all take one answer (a rank that looked
            # after the chief's write would skip the barrier below)
            done = bool(group_max(int(done), self._mesh))
        if done:
            return False
        if not force and step % self._interval:
            return False
        if self._best_metric and not (metrics and
                                      self._best_metric in metrics):
            raise ValueError(
                f"best_metric={self._best_metric!r} retention needs "
                f"metrics[{self._best_metric!r}] passed to save()")
        self._saved.add(step)
        obs.record_event("checkpoint_begin", step=step)
        with obs.span("checkpoint_save") as sp:
            # a ZeRO state gathers its optimizer rows, a split state its
            # pieces, on every rank
            tree = as_tree(state) if _collective(state) else None
            if self._is_chief():
                self.wait()
                host = self._to_host(tree or as_tree(state))
                metrics = {k: float(v) for k, v in metrics.items()} \
                    if metrics else None
                if self._async:
                    self._thread = threading.Thread(
                        target=self._write_in_background,
                        args=(step, host, metrics),
                        name=f"checkpoint-writer-{step}")
                    self._thread.start()
                else:
                    self._write(step, host, metrics)
            if force and collectives.group_size(self._mesh) > 1:
                self.wait()
                group_max(0, self._mesh)  # a barrier after the commit
        obs.record_event("checkpoint_end", step=step, saved=True,
                         blocking_s=round(sp.dur_s, 4))
        _M_SAVES.inc()
        _M_SAVE_S.set(sp.dur_s)
        # the goodput lost-work anchor: a resume is measured against the
        # newest save at or before its restored step
        obs.goodput.note_checkpoint(step)
        logger.info("checkpoint saved at step %d", step)
        return True

    def _to_host(self, tree) -> dict:
        """``tree`` with each tensor copied into this manager's host buffer
        for its path (pinned for a CUDA tensor; reused across saves),
        complete when this returns."""
        cuda = set()
        out = self._copy(tree, "", cuda)
        for device in cuda:
            # the copies were queued on the device's current stream after
            # the step that produced the state; wait for them once
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            event.synchronize()
        return out

    def _copy(self, tree, path: str, cuda: set):
        if isinstance(tree, torch.Tensor):
            buf = self._buffers.get(path)
            if buf is None or buf.shape != tree.shape \
                    or buf.dtype != tree.dtype:
                buf = torch.empty(tree.shape, dtype=tree.dtype,
                                  pin_memory=tree.is_cuda)
                self._buffers[path] = buf
            if tree.is_cuda:
                cuda.add(tree.device)
            buf.copy_(tree.detach(), non_blocking=tree.is_cuda)
            return buf
        if isinstance(tree, Mapping):
            return {k: self._copy(v, f"{path}/{k}", cuda)
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self._copy(v, f"{path}/{i}", cuda)
                              for i, v in enumerate(tree))
        return tree

    def _write_in_background(self, step, host, metrics) -> None:
        try:
            self._write(step, host, metrics)
        except BaseException as e:  # raised in the caller's thread by wait()
            self._error = e

    def _write(self, step: int, host: dict, metrics: dict | None) -> None:
        """Write ``step`` from its host copy: the payload under a temporary
        name, the manifest, the rename, the commit marker; then rotate."""
        tmp = os.path.join(self._directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, PAYLOAD), "wb") as f:
            torch.save(host, f)
            f.flush()
            os.fsync(f.fileno())
        if self._integrity:
            # the manifest describes the state as saved; a failed manifest
            # write leaves the step restorable but unverified, as in JAX
            try:
                integrity.write_manifest(self._directory, step,
                                         integrity.tree_checksums(host))
            except OSError:
                logger.exception("checkpoint manifest write failed for "
                                 "step %d (step stays restorable, just "
                                 "unverified)", step)
        final = self._step_dir(step)
        if os.path.exists(final):  # a half-written step without its marker
            shutil.rmtree(final)
        os.rename(tmp, final)
        marker = os.path.join(final, COMMIT_MARKER)
        with open(f"{marker}.tmp", "w") as f:
            json.dump({"step": step, "t": time.time(), "metrics": metrics}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(f"{marker}.tmp", marker)
        self._rotate()

    def _metrics(self, step: int) -> dict:
        try:
            with open(os.path.join(self._step_dir(step), COMMIT_MARKER)) as f:
                return json.load(f).get("metrics") or {}
        except (OSError, ValueError):
            return {}

    def _ranked(self, steps: list[int]) -> list[int]:
        """``steps`` best first by ``best_metric``; steps without the
        metric last."""
        sign = 1.0 if self._best_mode == "max" else -1.0

        def score(s):
            value = self._metrics(s).get(self._best_metric)
            return -float("inf") if value is None else sign * value

        return sorted(steps, key=score, reverse=True)

    def _rotate(self) -> None:
        if self._max_to_keep is None:
            return
        steps = self.all_steps()
        keep = (self._ranked(steps) if self._best_metric
                else sorted(steps, reverse=True))[:self._max_to_keep]
        for s in steps:
            if s not in keep:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)
        integrity.prune_manifests(self._directory, keep)

    def best_step(self) -> int | None:
        """Step of the best checkpoint under the ``best_metric`` policy."""
        if not self._best_metric:
            return None
        ranked = self._ranked(self.all_steps())
        return ranked[0] if ranked else None

    # ---------------------------------------------------------- restoring

    def restore_latest(self, target, *, before_step: int | None = None):
        """Restore the newest *verified* checkpoint into ``target`` (a
        ``TrainState``) and return it, or None when no step restores (a
        cold start, or every step was rejected).

        A step whose load raises (a truncated or unreadable file) or whose
        payload mismatches its save-time manifest is rejected, and the
        next-newest step is tried; ``last_restore_report`` says which.
        ``before_step`` keeps only strictly earlier steps."""
        steps = sorted(self.all_steps(), reverse=True)
        if before_step is not None:
            steps = [s for s in steps if s < before_step]
        rejected: list[dict] = []
        result, good_step = None, None
        for step in steps:
            try:
                result = self._restore_verified(step, target)
                good_step = step
                break
            except CheckpointCorruptError as e:
                reason = str(e)[:300]
                rejected.append({"step": step, "reason": reason})
                _M_VERIFY_FAILURES.inc()
                obs.record_event("checkpoint_corrupt", step=step,
                                 reason=reason)
                logger.error("checkpoint step %d failed verification (%s); "
                             "falling back to the next-newest checkpoint",
                             step, reason)
        self.last_restore_report = {"restored_step": good_step,
                                    "rejected": rejected}
        if result is not None and rejected:
            logger.warning("restored VERIFIED checkpoint step %d after "
                           "rejecting %d corrupt step(s): %s", good_step,
                           len(rejected), [r["step"] for r in rejected])
        elif result is None and rejected:
            logger.error("no verifiable checkpoint left (rejected %s); cold "
                         "start", [r["step"] for r in rejected])
        return result

    def _restore_verified(self, step: int, target):
        """Load ``step``, verify it against its manifest and copy it into
        ``target``; raises :class:`CheckpointCorruptError` when the load
        raises, the payload mismatches the manifest or its geometry is not
        the target's, before anything of the target changes.  A step
        without a manifest restores unverified."""
        with obs.span("checkpoint_restore"):
            self._load_verified(step, target)
        _M_RESTORES.inc()
        obs.goodput.note_restore(step)
        logger.info("restored checkpoint step %d", step)
        return target

    def _load_verified(self, step: int, target) -> None:
        path = os.path.join(self._step_dir(step), PAYLOAD)
        try:
            tree = torch.load(path, map_location="cpu", weights_only=True)
            whole = tree
            placement = getattr(target, "placement", None)
            if placement is not None:  # this rank's pieces of the whole
                tree = placement.cut_tree(tree, target.optimizer)
            saved = _check_geometry(tree, target)
        except Exception as e:
            raise CheckpointCorruptError(
                f"restore raised {type(e).__name__}: {str(e)[:200]}") from e
        manifest = integrity.load_manifest(self._directory, step)
        if manifest is not None:
            problems = integrity.verify_tree(whole, manifest)
            if problems:
                shown = "; ".join(problems[:3])
                if len(problems) > 3:
                    shown += f"; ... {len(problems) - 3} more"
                raise CheckpointCorruptError(shown)
        else:
            logger.info("checkpoint step %d has no integrity manifest; "
                        "restoring unverified", step)
        target.model.load_state_dict(saved)
        if getattr(target, "zero", None) is not None:
            target.zero.refresh_rows()  # the update starts from the rows
        target.optimizer.load_state_dict(
            zero_lib.localize_opt_state(tree["opt_state"], target))
        target.step = int(tree["step"])

    def item_metadata(self, step: int) -> dict | None:
        """The shapes of step ``step``'s saved tensors, a nested dict by
        path, read from its manifest (no tensor I/O; None without one):
        the probe of ``parallel.zero.saved_opt_layout``."""
        manifest = integrity.load_manifest(self._directory, step)
        if manifest is None:
            return None
        tree: dict = {}
        for key, rec in manifest["arrays"].items():
            node, parts = tree, key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = tuple(rec["shape"])
        return tree

    def restore(self, step: int, target):
        """Restore ``step`` into ``target``, verified against its manifest;
        raises :class:`CheckpointCorruptError` (no fallback: the caller
        asked for this step) on a failed load or a mismatch.  A missing
        step or file raises ``FileNotFoundError`` as itself: a reader
        polling a live writer's directory retries on it."""
        if int(step) not in self.all_steps():
            raise FileNotFoundError(f"no committed checkpoint step {step} "
                                    f"in {self._directory}")
        try:
            return self._restore_verified(step, target)
        except CheckpointCorruptError as e:
            if isinstance(e.__cause__, FileNotFoundError):
                raise e.__cause__
            _M_VERIFY_FAILURES.inc()
            obs.record_event("checkpoint_corrupt", step=step,
                             reason=str(e)[:300])
            raise

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return max(steps) if steps else None

    def all_steps(self) -> list[int]:
        """Committed steps only: a step directory without its commit
        marker (a save cut short) is not a checkpoint."""
        steps = []
        try:
            names = os.listdir(self._directory)
        except FileNotFoundError:
            return steps
        for name in names:
            d = os.path.join(self._directory, name)
            if not name.isdigit() or not os.path.isdir(d):
                continue
            if not os.path.exists(os.path.join(d, COMMIT_MARKER)):
                logger.warning("ignoring half-written checkpoint dir %s (no "
                               "commit marker)", d)
                continue
            steps.append(int(name))
        return sorted(steps)

    def reload(self) -> None:
        """Re-scan for checkpoints written by other processes: a no-op,
        the step list is read from the directory on every call."""

    def wait(self) -> None:
        """Wait for the save in flight; raise its failure, if it failed."""
        if self._thread is not None:
            with obs.span("checkpoint_wait"):
                self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def close(self) -> None:
        self.wait()
