"""Device-memory and host-memory telemetry.

Twin of ``distributedtensorflow_tpu/obs/memory.py``.  Device-memory
exhaustion creeps: fragmentation and stray live tensors grow for hours
before the OOM.  This module makes the creep visible on three surfaces
without attaching a profiler:

- per-device memory in use and peak from the CUDA caching allocator
  (``torch.cuda.memory_stats(device)`` of each local device:
  ``allocated_bytes.all.current`` and ``.peak``, what JAX's
  ``bytes_in_use`` and ``peak_bytes_in_use`` mean; an empty result
  without a CUDA device, as JAX's on a backend without ``memory_stats``);
- host RSS from ``/proc/self/statm`` (portable ``resource`` fallback);
- a live-tensor census.  ``jax.live_arrays()`` has no torch twin; the
  allocator's active blocks stand in for it (``active.all.current``
  blocks, ``active_bytes.all.current`` bytes), under the same field names
  (``live_arrays``, ``live_arrays_gib``).  A block is not a tensor (views
  share one, the allocator rounds sizes up), so the count is the
  allocator's, not the tensors', and there is no per-tensor ``top`` list.

Consumers: :func:`record_fields` rides the per-step ``metrics.jsonl``
record (flat scalars), :func:`update_registry` refreshes labeled gauges
for the Prometheus snapshot and ``/varz``, and :func:`memz` is the
``/memz`` endpoint's full JSON payload.  Nothing here syncs the device:
the allocator's statistics are host-side counters.  Each call names its
device explicitly, so a status-server thread (whose current device is
``cuda:0``) reads the rank's own card.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger(__name__)

__all__ = [
    "collect",
    "device_memory_snapshot",
    "host_rss_bytes",
    "live_arrays_census",
    "local_devices",
    "set_local_devices",
    "record_fields",
    "update_registry",
    "memz",
    "tree_bytes_by_device",
    "state_bytes_report",
    "state_bytes_record_fields",
    "set_train_state_bytes",
    "train_state_record_fields",
]

_GIB = 1.0 / (1024 ** 3)


#: The devices :func:`local_devices` names, set by the Trainer on the fit
#: loop's thread (None: ask the calling thread).
_LOCAL_DEVICES: list | None = None


def set_local_devices(devices: list | None) -> None:
    """Name the devices this process drives (None: forget them).  A
    thread's current CUDA device is ``cuda:0`` until it sets one, so the
    status server's handler threads read the devices named here."""
    global _LOCAL_DEVICES
    _LOCAL_DEVICES = None if devices is None else list(devices)


def local_devices() -> list:
    """The CUDA devices this process drives: those named by
    :func:`set_local_devices`, else the calling thread's current device
    once CUDA is initialised; none without CUDA."""
    import torch  # noqa: PLC0415

    if _LOCAL_DEVICES is not None:
        return [d for d in _LOCAL_DEVICES if d.type == "cuda"]
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return []
    return [torch.device("cuda", torch.cuda.current_device())]


def device_memory_snapshot(devices=None) -> list[dict]:
    """One dict per device (default: :func:`local_devices`) from the CUDA
    caching allocator: ``bytes_in_use``, ``peak_bytes_in_use``,
    ``bytes_reserved``, ``num_allocs`` and the live-block census
    ``active_blocks``/``active_bytes``."""
    import torch  # noqa: PLC0415

    out = []
    for d in (local_devices() if devices is None else devices):
        entry: dict = {"id": int(d.index or 0), "platform": "gpu"}
        stats = torch.cuda.memory_stats(d)
        for key, name in (("allocated_bytes.all.current", "bytes_in_use"),
                          ("allocated_bytes.all.peak", "peak_bytes_in_use"),
                          ("reserved_bytes.all.current", "bytes_reserved"),
                          ("allocation.all.allocated", "num_allocs"),
                          ("active.all.current", "active_blocks"),
                          ("active_bytes.all.current", "active_bytes")):
            if key in stats:
                entry[name] = int(stats[key])
        out.append(entry)
    return out


def host_rss_bytes() -> int | None:
    """Current resident set size of this process, or None if unknowable."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource  # noqa: PLC0415
        import sys  # noqa: PLC0415

        # ru_maxrss is the PEAK — a coarser fallback, but peak RSS still
        # catches host-side leaks on non-/proc platforms.  Units differ:
        # KiB on Linux, bytes on macOS.
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return peak if sys.platform == "darwin" else peak * 1024
    except Exception:
        return None


def live_arrays_census(snapshot: list[dict] | None = None) -> dict:
    """Count and bytes of the live tensors' memory, summed over the
    devices: the allocator's active blocks (see the module docstring).
    ``top`` stays empty: the allocator keeps no shapes."""
    devices = device_memory_snapshot() if snapshot is None else snapshot
    return {
        "count": sum(d.get("active_blocks", 0) for d in devices),
        "bytes": sum(d.get("active_bytes", 0) for d in devices),
        "top": [],
    }


def collect() -> dict:
    """One full snapshot — per-device stats, host RSS, live-tensor census
    — taken ONCE and fed to every consumer at a boundary."""
    devices = device_memory_snapshot()
    return {
        "devices": devices,
        "host_rss_bytes": host_rss_bytes(),
        "live_arrays": live_arrays_census(devices),
    }


def record_fields(snapshot: dict | None = None) -> dict[str, float]:
    """Flat scalars for the per-step metric record: the first device's
    memory (under the JAX package's ``hbm_in_use_gib``/``hbm_peak_gib``
    names), host RSS, and the live-tensor census.  Absent sources
    contribute nothing."""
    snap = snapshot or collect()
    out: dict[str, float] = {}
    if snap["devices"]:
        d0 = snap["devices"][0]
        if "bytes_in_use" in d0:
            out["hbm_in_use_gib"] = d0["bytes_in_use"] * _GIB
        if "peak_bytes_in_use" in d0:
            out["hbm_peak_gib"] = d0["peak_bytes_in_use"] * _GIB
    if snap["host_rss_bytes"] is not None:
        out["host_rss_gib"] = snap["host_rss_bytes"] * _GIB
    census = snap["live_arrays"]
    out["live_arrays"] = float(census["count"])
    out["live_arrays_gib"] = census["bytes"] * _GIB
    return out


def update_registry(registry=None, snapshot: dict | None = None) -> None:
    """Refresh the labeled memory gauges (``device=<id>`` per device) in
    ``registry`` (default: the process registry) for Prometheus/``/varz``."""
    from . import registry as reglib  # noqa: PLC0415

    reg = registry or reglib.default_registry()
    snap = snapshot or collect()
    in_use = reg.gauge("device_memory_in_use_bytes",
                       "device memory bytes in use")
    peak = reg.gauge("device_memory_peak_bytes",
                     "peak device memory bytes in use")
    for d in snap["devices"]:
        if "bytes_in_use" in d:
            in_use.set(d["bytes_in_use"], device=str(d["id"]))
        if "peak_bytes_in_use" in d:
            peak.set(d["peak_bytes_in_use"], device=str(d["id"]))
    if snap["host_rss_bytes"] is not None:
        reg.gauge("host_rss_bytes", "process resident set size").set(
            snap["host_rss_bytes"]
        )
    census = snap["live_arrays"]
    reg.gauge("live_arrays", "live allocator blocks").set(census["count"])
    reg.gauge("live_arrays_bytes", "bytes of live allocator blocks").set(
        census["bytes"]
    )


def memz() -> dict:
    """Full ``/memz`` payload — :func:`collect`, plus the train-state
    bytes breakdown when a trainer has installed one
    (:func:`set_train_state_bytes`)."""
    out = collect()
    if _TRAIN_STATE_BYTES is not None:
        out["train_state"] = _TRAIN_STATE_BYTES
    return out


# --- train-state bytes: the number weight-update sharding shrinks -----------
#
# Shapes and shardings are fixed for a fit, so the breakdown is computed
# ONCE at fit begin (never per step) and served statically on /memz, the
# labeled registry gauges, and the per-record fields.

_TRAIN_STATE_BYTES: dict | None = None


def tree_bytes_by_device(tensors) -> dict[int, int]:
    """Bytes of ``tensors`` (an iterable of tensors) summed per device
    index; the CPU counts as device 0 (the JAX package's CPU device id).
    A tensor counted twice (a tied weight) counts once."""
    out: dict[int, int] = {}
    seen: set[int] = set()
    for t in tensors:
        if id(t) in seen:
            continue
        seen.add(id(t))
        dev = int(t.device.index or 0)
        out[dev] = out.get(dev, 0) + t.numel() * t.element_size()
    return out


def _optimizer_tensors(optimizer):
    import torch  # noqa: PLC0415

    for per_param in optimizer.state.values():
        for v in per_param.values():
            if isinstance(v, torch.Tensor):
                yield v


def state_bytes_report(model, optimizer) -> dict:
    """The per-device train-state bytes breakdown — the one place of the
    byte-accounting rule: ``{"params": {device: bytes}, "opt_state":
    {device: bytes}}`` of the model's parameters and the tensors of the
    optimizer's state (the moments; empty before its first step)."""
    return {
        "params": tree_bytes_by_device(model.parameters()),
        "opt_state": tree_bytes_by_device(_optimizer_tensors(optimizer)),
    }


def state_bytes_record_fields(report: dict) -> dict[str, float]:
    """Flatten a :func:`state_bytes_report` into the record/bench fields:
    the WORST (max) device's bytes of params and optimizer state."""
    out: dict[str, float] = {}
    for key, field in (("params", "params_bytes_per_device"),
                       ("opt_state", "opt_state_bytes_per_device")):
        per_dev = report.get(key)
        if per_dev:
            out[field] = float(max(per_dev.values()))
    return out


def set_train_state_bytes(report: dict | None,
                          registry=None) -> None:
    """Install (or clear, with None) the per-device train-state bytes
    breakdown: ``{"params": {dev: bytes}, "opt_state": {...}, ...}`` plus
    scalar annotations (``zero_stage``, ``zero_degree``).  Refreshes the
    ``params_bytes_per_device`` / ``optimizer_state_bytes_per_device``
    labeled gauges so /varz and metrics.prom carry the breakdown too."""
    global _TRAIN_STATE_BYTES
    _TRAIN_STATE_BYTES = report
    if report is None:
        return
    from . import registry as reglib  # noqa: PLC0415

    reg = registry or reglib.default_registry()
    gauges = {
        "params": reg.gauge(
            "params_bytes_per_device", "parameter bytes resident per device"
        ),
        "opt_state": reg.gauge(
            "optimizer_state_bytes_per_device",
            "optimizer-state bytes resident per device (the bytes "
            "weight-update sharding divides by the ZeRO degree)",
        ),
    }
    for key, gauge in gauges.items():
        for dev, nbytes in (report.get(key) or {}).items():
            gauge.set(nbytes, device=str(dev))


def train_state_record_fields() -> dict[str, float]:
    """Flat scalars for the metric record: the WORST (max) per-device
    bytes of params and optimizer state, plus the ZeRO annotations —
    what run_report and bench_probe surface so a sharding win is a
    number, not an assertion."""
    rep = _TRAIN_STATE_BYTES
    if not rep:
        return {}
    out = state_bytes_record_fields(rep)
    for key in ("zero_stage", "zero_degree"):
        if isinstance(rep.get(key), (int, float)):
            out[key] = float(rep[key])
    return out
