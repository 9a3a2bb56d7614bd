"""Cross-host aggregation of per-host gauge snapshots.

Twin of ``distributedtensorflow_tpu/obs/aggregate.py``.  Data-parallel
training is only as fast as its slowest rank: a straggler's data stall or
GC pause stalls every collective.  Every rank publishes a small dict of
scalars (step time, data wait), one ``all_gather`` of a float64 tensor
over the data-parallel group collects them
(:func:`..parallel.collectives.all_gather`; the tensor lives on the CPU
for gloo and on the rank's own device for NCCL), and the chief logs
min/median/max plus which rank is the straggler.

The gather runs at **log boundaries only** (it is a collective — never
put it on the per-step path).  Keys must be identical on every rank
(they derive from the same TrainerConfig, so they are).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..parallel import collectives

logger = logging.getLogger(__name__)

__all__ = ["host_aggregate", "spread_ratio", "straggler_summary"]


def host_aggregate(values: dict[str, float],
                   group=None) -> dict[str, float]:
    """Allgather ``values`` from every rank of ``group`` (a process group,
    a mesh, or None for the default group); return spread fields.

    For each input key ``k`` the result carries ``k_host_min`` /
    ``k_host_median`` / ``k_host_max`` and ``k_straggler`` (the rank
    holding the max — for wait-style metrics the slowest rank).
    A world of one: computed locally, no collective.
    """
    keys = sorted(values)
    if not keys:
        return {}
    local = np.asarray([float(values[k]) for k in keys], np.float64)
    group = collectives.resolve_group(group)
    if group is None or group.size() == 1:
        rows = local[None, :]
    else:
        device = torch.device("cpu")
        if group.name() == "nccl":
            device = torch.device("cuda", torch.cuda.current_device())
        gathered = collectives.all_gather(
            torch.as_tensor(local, device=device), group, tiled=False)
        rows = gathered.cpu().numpy().reshape(group.size(), len(keys))
    out: dict[str, float] = {}
    for j, k in enumerate(keys):
        col = rows[:, j]
        out[f"{k}_host_min"] = float(col.min())
        out[f"{k}_host_median"] = float(np.median(col))
        out[f"{k}_host_max"] = float(col.max())
        out[f"{k}_straggler"] = float(int(col.argmax()))
    return out


def spread_ratio(agg: dict[str, float], key: str) -> float:
    """Cross-host spread of a gathered key: ``host_max / host_median``.

    1.0 = perfectly balanced; large = one rank is dragging every
    collective.  This is the straggler-blowup signal the reactive
    profiler (``obs.capture.CaptureEngine``) arms on when
    ``TrainerConfig.auto_profile`` is set.  Returns 1.0 when the fields
    are absent or the median is non-positive (nothing to compare)."""
    med = agg.get(f"{key}_host_median")
    mx = agg.get(f"{key}_host_max")
    if not isinstance(med, (int, float)) or not isinstance(mx, (int, float)):
        return 1.0
    if med <= 0:
        return 1.0
    return float(mx) / float(med)


def straggler_summary(agg: dict[str, float], key: str) -> str:
    """One log line for a gathered key: ``step_time min/med/max straggler``."""
    try:
        return (
            f"{key} host min/median/max = "
            f"{agg[f'{key}_host_min']:.4g}/"
            f"{agg[f'{key}_host_median']:.4g}/"
            f"{agg[f'{key}_host_max']:.4g}s "
            f"(straggler host {int(agg[f'{key}_straggler'])})"
        )
    except KeyError:
        return f"{key}: no aggregation fields"
