"""Telemetry of the port: metrics registry, span tracing, cross-rank
aggregation, anomaly detection, the flight recorder, the goodput ledger,
memory and MFU accounting, reactive profiling and the status server.

Twin of ``distributedtensorflow_tpu/obs/``, every module of it:

- ``counter/gauge/histogram`` — process-local registry metrics, exported
  into ``metrics.jsonl`` rows and a Prometheus text snapshot
  (``metrics.prom``);
- ``span("name")`` — wall-time tree tracing into ``trace.jsonl`` plus the
  per-step breakdown fields (``t_data``/``t_step``/``f_data``/...);
- ``host_aggregate`` — per-rank gauge all-gather -> min/median/max/
  straggler;
- ``AnomalyDetector`` — NaN/Inf loss, loss z-spike, step-time regression;
- ``FlightRecorder`` — bounded ring of structured events, dumped to
  ``flight.jsonl`` on watchdog timeout / crash / anomaly / preemption;
- ``StatusServer`` — stdlib HTTP thread serving ``/healthz``,
  ``/statusz``, ``/varz``, ``/threadz``, ``/memz``, ``/flightz``,
  ``/goodputz``, ``/profilez``;
- ``memory`` — per-device allocator memory, host RSS and the live-block
  census, feeding the registry, the per-step record, and ``/memz``;
- ``GoodputLedger`` — wall-time accounting into exclusive buckets,
  persisted to ``goodput.json`` and merged across restarts;
- ``CaptureEngine`` — anomaly-/straggler-triggered, on-demand and static
  ``torch.profiler`` windows with a budget and a ``captures.jsonl``
  manifest;
- ``mfu_record_fields`` — MFU against the card's published peak, for the
  NVIDIA kinds it knows;
- ``usage.UsageMeter`` — the serving engine's per-tenant ledger
  (``usage.jsonl``, ``GET /usagez``);
- ``FleetAggregator`` — the fleet plane: a chief-side scraper over peer
  StatusServers' ``/varz`` (through ``net.rpc``) merging samples into
  one min/median/max/sum view with per-peer up/stale/down liveness and
  ``spread_ratio`` straggler detection, at ``/fleetz`` and in
  ``fleet.json``;
- ``SLOMonitor`` — declarative SLO rules (JSON) as multi-window burn
  rates (``slo_burn_rate{slo=,window=}``), ``slo_violation`` flight
  events, ``/sloz``, and a ``slo_burn`` capture on a fast-burn trip;
- ``AlertManager`` — declarative alert rules over registry scalars,
  history series and fleet-merged samples (``threshold`` / ``burn`` /
  ``absence`` / ``anomaly``), fanning out to log/webhook/capture sinks,
  ``alerts.jsonl``, incident bundles (``incidents/<id>/``), ``/alertz``
  and the ``/healthz?deep=1`` verdict;
- ``DynamicsMonitor`` — per-module grad/param/update statistics computed
  inside the train step on a cadence, flushed into ``dynamics.jsonl``,
  the ``dynamics_*`` families and ``/dynamicz``, with a NaN-provenance
  pass naming the first module to go non-finite;
- ``MetricsHistory`` — fixed-memory downsampling rings over registry
  samples (plus fleet merges and SLO good/total snapshots), ``/histz``
  and ``history.jsonl``.

Every singleton here (the default registry, recorder, ledger, tracer and
capture engine) is the port's own, distinct from the JAX package's.
"""

from . import (  # noqa: F401
    alerts,
    capture,
    dynamics,
    fleet,
    flight_recorder,
    goodput,
    memory,
    slo,
    tsdb,
)
from .alerts import AlertManager, AlertRule  # noqa: F401
from .aggregate import (  # noqa: F401
    host_aggregate,
    spread_ratio,
    straggler_summary,
)
from .anomaly import Anomaly, AnomalyDetector  # noqa: F401
from .capture import CaptureEngine  # noqa: F401
from .dynamics import DynamicsMonitor  # noqa: F401
from .fleet import FleetAggregator  # noqa: F401
from .flight_recorder import (  # noqa: F401
    FlightRecorder,
    default_recorder,
    install_recorder,
    record_event,
)
from .goodput import GoodputLedger  # noqa: F401
from .mfu import mfu_record_fields, peak_flops  # noqa: F401
from .registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    Registry,
    counter,
    default_registry,
    gauge,
    histogram,
    set_default_registry,
)
from .server import StatusServer  # noqa: F401
from .slo import SLOMonitor, SLORule  # noqa: F401
from .tsdb import MetricsHistory  # noqa: F401
from .tracing import (  # noqa: F401
    Span,
    TraceRecorder,
    active_recorder,
    current_context,
    new_trace_id,
    record_remote_span,
    remote_span,
    span,
)
