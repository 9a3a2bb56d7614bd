"""Adaptive prefetch depth of the input plane.

Twin of ``distributedtensorflow_tpu/data/adaptive.py``: one controller
class drives both depths the input plane tunes while it runs,

- the :class:`data.Prefetcher`'s host-to-device buffer depth, and
- the :class:`data.DataServiceClient`'s per-split credit window,

from the signal the ``data_wait_seconds`` histogram records, the time the
consumer blocks on its next batch:

- **grow** while the consumer blocks (the mean wait over the last
  ``interval`` pops above ``grow_wait_s``): the input is the bottleneck
  or bursty, and more batches in flight absorb the jitter;
- **shrink** when the waits are about 0 (below ``shrink_wait_s``): the
  buffer is always full, and every extra slot is memory held for nothing;
- always within ``[min_depth, max_depth]`` and a **bytes budget**: the cap
  is ``bytes_budget // EWMA(batch bytes)`` (:meth:`note_bytes`), so a
  fatter batch makes a shallower queue.

Every decision is exported: the gauge ``data_prefetch_depth{component=}``
holds the live depth, the counter
``data_prefetch_resizes_total{component=,direction=}`` counts the
decisions, and :func:`input_record_fields` stamps the depths into every
record the Trainer logs while the controller's owner is open: a closed
Prefetcher or client unregisters its controller, where the reference's
stays registered until another replaces it.  The reference's no-op shims
for a host without its ``obs`` (which pulls jax there) are gone: the
port's registry imports no framework, so the telemetry is always real.
"""

from __future__ import annotations

import threading

from ..obs.registry import counter as _counter
from ..obs.registry import gauge as _gauge

#: Live controllers by component ("prefetcher" / "client"), for the record
#: fields.  The last one made wins: one Prefetcher and one client a
#: training process is what ``train_torch.py`` builds.
_CONTROLLERS: dict[str, "AdaptiveDepthController"] = {}
_CONTROLLERS_LOCK = threading.Lock()

#: Component -> metric-record field.
_RECORD_FIELDS = {
    "prefetcher": "data_prefetch_depth",
    "client": "data_client_window",
}


class AdaptiveDepthController:
    """A queue depth or credit window tuned from the consumer's waits.

    Threads: ``observe_wait`` is called by the consumer, ``note_bytes`` by
    the producers, ``depth`` read from anywhere; every update runs under
    one small lock (once a batch, never per element)."""

    def __init__(
        self,
        *,
        initial: int = 2,
        min_depth: int = 1,
        max_depth: int = 16,
        grow_wait_s: float = 2e-3,
        shrink_wait_s: float = 2e-4,
        interval: int = 8,
        bytes_budget: int | None = None,
        component: str = "prefetcher",
    ):
        if min_depth < 1 or max_depth < min_depth:
            raise ValueError(f"bad depth bounds [{min_depth}, {max_depth}]")
        if shrink_wait_s > grow_wait_s:
            raise ValueError(
                f"shrink_wait_s {shrink_wait_s} exceeds grow_wait_s "
                f"{grow_wait_s} (the controller would oscillate)")
        self.min_depth = int(min_depth)
        self.max_depth = int(max_depth)
        self.grow_wait_s = float(grow_wait_s)
        self.shrink_wait_s = float(shrink_wait_s)
        self.interval = max(1, int(interval))
        self.bytes_budget = bytes_budget
        self.component = component
        self._lock = threading.Lock()
        self._depth = min(max(int(initial), self.min_depth), self.max_depth)
        self._waits: list[float] = []
        self._item_bytes = 0.0  # EWMA of the batches' bytes
        self._g_depth = _gauge(
            "data_prefetch_depth",
            "live adaptive prefetch depth / credit window")
        self._m_resizes = _counter(
            "data_prefetch_resizes_total",
            "adaptive depth-controller decisions")
        self._g_depth.set(self._depth, component=component)
        with _CONTROLLERS_LOCK:
            _CONTROLLERS[component] = self

    @property
    def depth(self) -> int:
        return self._depth

    @property
    def item_bytes(self) -> float:
        return self._item_bytes

    def byte_cap(self) -> int:
        """The depth the bytes budget allows (``max_depth`` without a
        budget or before the first batch's size is known)."""
        if not self.bytes_budget or self._item_bytes <= 0:
            return self.max_depth
        return min(self.max_depth,
                   max(self.min_depth,
                       int(self.bytes_budget // self._item_bytes)))

    def note_bytes(self, nbytes: int) -> None:
        with self._lock:
            self._item_bytes = (
                float(nbytes) if self._item_bytes == 0.0
                else 0.9 * self._item_bytes + 0.1 * float(nbytes))
            # over the budget: shrink now, not at the next wait window
            cap = self.byte_cap()
            if self._depth > cap:
                self._set_depth(cap, "shrink")

    def observe_wait(self, seconds: float) -> int:
        """Record one blocking time of the consumer; returns the depth,
        updated at the end of each window of ``interval`` waits."""
        with self._lock:
            self._waits.append(float(seconds))
            if len(self._waits) >= self.interval:
                mean = sum(self._waits) / len(self._waits)
                self._waits.clear()
                cap = self.byte_cap()
                d = self._depth
                if mean > self.grow_wait_s:
                    d += 1
                elif mean < self.shrink_wait_s:
                    d -= 1
                d = min(max(d, self.min_depth), cap)
                if d != self._depth:
                    self._set_depth(d, "grow" if d > self._depth
                                    else "shrink")
            return self._depth

    def unregister(self) -> None:
        """Leave the record fields (the owner closed); the gauge keeps
        the last depth."""
        with _CONTROLLERS_LOCK:
            if _CONTROLLERS.get(self.component) is self:
                del _CONTROLLERS[self.component]

    def _set_depth(self, d: int, direction: str) -> None:
        self._depth = d
        self._g_depth.set(d, component=self.component)
        self._m_resizes.inc(direction=direction, component=self.component)


def input_record_fields() -> dict[str, float]:
    """The live input-plane depths as record fields
    (``data_prefetch_depth``, ``data_client_window``); empty while no
    adaptive controller runs."""
    out: dict[str, float] = {}
    with _CONTROLLERS_LOCK:
        for component, ctl in _CONTROLLERS.items():
            field = _RECORD_FIELDS.get(component)
            if field is not None:
                out[field] = float(ctl.depth)
    return out
