"""Fleet observability plane: cross-process ``/varz`` aggregation.

Twin of ``distributedtensorflow_tpu/obs/fleet.py``, framework-free and
copied whole; peers are scraped through the port's ``net.rpc`` and the
page parsed is the Prometheus text that the port's ``StatusServer``
writes at ``/varz``.

Every process of a run is observable on its own (registry,
``StatusServer``, flight recorder); a run of several processes — trainer
ranks, a serve frontend — is a *fleet*.  Each silo answers for itself;
none can answer the fleet-scale questions: *which worker is the
straggler*, *is any peer down*, *what does the whole fleet's metric
surface look like right now*.

:class:`FleetAggregator` is the chief-side answer: a background thread
scrapes the ``/varz`` Prometheus snapshot of a registered set of peer
``StatusServer``s, merges the samples into one fleet view with per-metric
min/median/max/sum, tracks per-peer liveness/staleness, and serves the
result at ``GET /fleetz`` (text + ``?json``) on the chief's own
StatusServer.  Straggler detection reuses ``aggregate.spread_ratio``
(host max / host median — the same signal the reactive profiler arms on).

Peer states (the ``fleet_peers{state=}`` gauge family):

- ``up``    — the last scrape succeeded;
- ``stale`` — the last scrape failed *softly* (timeout, transient socket
  error) and the last success is within ``stale_after_s``;
- ``down``  — the peer refused the connection (its server is gone), its
  exposition was malformed (a sick peer must never poison the merged
  view), it answered non-200, or no success within ``stale_after_s``.

The merge uses the last-known samples of ``up``/``stale`` peers only;
``down`` peers contribute nothing.  A malformed page drops the WHOLE
peer for that round — a half-parsed registry would split every histogram
family inconsistently.

Each scrape round also persists a small snapshot to ``<logdir>/fleet.json``
(atomic tmp+rename) — peer states, the worst straggler spread, merged-key
count — the post-hoc artifact ``tools/run_report.py``'s "fleet" section
and ``tools/check_metrics_schema.py`` consume.

Registry metrics: ``fleet_peers{state=up|stale|down}`` gauges,
``fleet_scrape_seconds{peer=}`` histograms, ``fleet_scrapes_total{outcome=
ok|error}`` counters.
"""

from __future__ import annotations

import json
import logging
import os
import re
import statistics
import threading
import time
import urllib.error
import urllib.request

from . import registry as reglib
from .aggregate import spread_ratio

logger = logging.getLogger(__name__)

__all__ = [
    "FleetAggregator",
    "FleetScrapeError",
    "PEER_STATES",
    "merge_samples",
    "parse_prometheus",
]

#: The known peer states (``fleet_peers{state=}`` label set; the schema
#: checker mirrors this tuple).
PEER_STATES = ("up", "stale", "down")

#: Default straggler keys: spread is computed for every merged key, but
#: the "worst straggler" verdict only considers keys where max/median is a
#: meaningful imbalance signal (per-worker work counters, step timing).
DEFAULT_STRAGGLER_KEYS = (
    "data_service_batches_served_total",
    "data_batches_total",
    "steps_per_sec",
)

_SAMPLE_RE = re.compile(r"^([A-Za-z_:][A-Za-z0-9_:]*(?:\{[^}]*\})?)\s+(\S+)$")


class FleetScrapeError(ValueError):
    """A peer's ``/varz`` page was malformed (bad sample line / value)."""


def parse_prometheus(text: str) -> dict[str, float]:
    """Parse a Prometheus text-exposition page into ``{sample_key: value}``
    where the key is the raw ``name{labels}`` string (labels kept verbatim
    so identical series align across peers).

    Raises :class:`FleetScrapeError` on any malformed non-comment line —
    the aggregator marks that peer ``down`` for the round rather than
    merging a half-parsed page."""
    out: dict[str, float] = {}
    for i, line in enumerate(text.splitlines(), start=1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise FleetScrapeError(f"line {i}: not a prometheus sample: "
                                   f"{line[:120]!r}")
        key, value = m.groups()
        try:
            out[key] = float(value)  # accepts +Inf/-Inf/NaN spellings
        except ValueError as e:
            raise FleetScrapeError(
                f"line {i}: sample {key} value {value!r} is not a number"
            ) from e
    return out


def merge_samples(
    samples_by_peer: dict[str, dict[str, float]],
) -> dict[str, dict[str, float]]:
    """Merge per-peer sample maps into the fleet view:
    ``{sample_key: {"min", "median", "max", "sum", "n", "max_peer"}}``.

    Pure arithmetic (unit-testable on degenerate inputs): a single peer
    yields min == median == max == sum with n == 1; an empty input yields
    ``{}``.  Non-finite samples are skipped — one peer's NaN must not
    poison the fleet min/median/max."""
    import math

    merged: dict[str, dict[str, float]] = {}
    by_key: dict[str, list[tuple[str, float]]] = {}
    for peer, samples in samples_by_peer.items():
        for key, value in samples.items():
            if not isinstance(value, (int, float)) or not math.isfinite(value):
                continue
            by_key.setdefault(key, []).append((peer, float(value)))
    for key, pairs in by_key.items():
        values = [v for _, v in pairs]
        max_peer = max(pairs, key=lambda pv: pv[1])[0]
        merged[key] = {
            "min": min(values),
            "median": float(statistics.median(values)),
            "max": max(values),
            "sum": float(sum(values)),
            "n": float(len(values)),
            "max_peer": max_peer,
        }
    return merged


def _spread(entry: dict[str, float]) -> float:
    """Spread ratio of one merged entry via ``aggregate.spread_ratio``
    (reused verbatim: build the ``host_*`` field shape it reads)."""
    return spread_ratio(
        {"v_host_median": entry["median"], "v_host_max": entry["max"]}, "v"
    )


class _Peer:
    __slots__ = ("name", "addr", "samples", "last_ok_t", "last_err",
                 "state", "ok", "errors")

    def __init__(self, name: str, addr: str):
        self.name = name
        self.addr = addr
        self.samples: dict[str, float] = {}
        self.last_ok_t: float | None = None
        self.last_err: str | None = None
        self.state = "down"  # until the first successful scrape
        self.ok = 0
        self.errors = 0


class FleetAggregator:
    """Background scraper + merger over a registered set of peer
    StatusServers.  Construct, :meth:`add_peer`, :meth:`install` onto the
    chief's StatusServer, :meth:`start`; or drive :meth:`scrape_once`
    synchronously (tests)."""

    def __init__(
        self,
        *,
        interval_s: float = 2.0,
        timeout_s: float = 2.0,
        stale_after_s: float | None = None,
        logdir: str | None = None,
        registry=None,
        straggler_keys: tuple[str, ...] = DEFAULT_STRAGGLER_KEYS,
        spread_threshold: float = 2.0,
    ):
        self.interval_s = max(float(interval_s), 0.05)
        self.timeout_s = float(timeout_s)
        #: A softly-failing peer (timeout) is ``stale`` until its last
        #: success is this old, then ``down``.  Default: 3 intervals.
        self.stale_after_s = (
            float(stale_after_s) if stale_after_s is not None
            else 3.0 * self.interval_s
        )
        self.logdir = logdir
        self.straggler_keys = tuple(straggler_keys)
        self.spread_threshold = float(spread_threshold)
        self._lock = threading.Lock()
        self._peers: dict[str, _Peer] = {}
        self._merged: dict[str, dict[str, float]] = {}
        self._worst_spread: dict | None = None
        self._rounds = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        reg = registry or reglib.default_registry()
        self._m_peers = reg.gauge(
            "fleet_peers", "registered fleet peers by scrape state"
        )
        self._m_scrape = reg.histogram(
            "fleet_scrape_seconds", "per-peer /varz scrape wall time"
        )
        self._m_scrapes = reg.counter(
            "fleet_scrapes_total", "peer scrape attempts by outcome"
        )

    # -- membership ----------------------------------------------------------

    def add_peer(self, name: str, addr: str) -> None:
        """Register a peer StatusServer at ``addr`` (``host:port``)."""
        if not name or not addr:
            raise ValueError(f"bad peer name={name!r} addr={addr!r}")
        with self._lock:
            self._peers[str(name)] = _Peer(str(name), str(addr))

    def remove_peer(self, name: str) -> None:
        with self._lock:
            self._peers.pop(name, None)

    def peers(self) -> dict[str, str]:
        with self._lock:
            return {p.name: p.addr for p in self._peers.values()}

    # -- scraping ------------------------------------------------------------

    def _fetch(self, addr: str, peer_name: str = "") -> str:
        """GET one peer's /varz under a HARD per-peer deadline
        (``net.rpc.http_get``): connect, headers and every body chunk
        are charged to one budget, so a hung or byte-trickling peer can
        cost at most ``timeout_s`` — it can no longer stall the scrape
        round past ``interval_s`` by stringing per-op timeouts along."""
        from ..net import rpc as netrpc  # noqa: PLC0415

        status, body = netrpc.http_get(
            f"http://{addr}/varz",
            deadline_s=min(self.timeout_s, self.interval_s),
            endpoint=f"fleet_peer:{peer_name or addr}",
        )
        if status != 200:
            raise FleetScrapeError(f"/varz answered HTTP {status}")
        return body

    def _classify_failure(self, peer: _Peer, err: Exception,
                          now: float) -> str:
        """down vs stale: a refused connection, an HTTP error status, or
        a malformed page is an unambiguous ``down`` (the server is gone
        or sick); a deadline miss or transient socket error is ``stale``
        while the last success is recent — the acceptance contract is
        that a KILLED peer flips to ``down`` within one scrape
        interval."""
        from ..net import BreakerOpenError
        from ..net.rpc import DeadlineExceeded

        if isinstance(err, BreakerOpenError) and peer.state == "down":
            # The open breaker gathered no fresh evidence — the previous
            # rounds' verdict stands.  A peer already marked down (its
            # refused connections are what tripped the breaker) must not
            # oscillate back to stale whenever the scrape interval
            # undercuts the breaker cooldown.
            return "down"
        if isinstance(err, (DeadlineExceeded, BreakerOpenError)):
            # Soft: a hung-but-listening peer (or a breaker pacing one)
            # means "try again next round", not "gone".
            if peer.last_ok_t is not None \
                    and (now - peer.last_ok_t) <= self.stale_after_s:
                return "stale"
            return "down"
        # HTTPError first: it subclasses URLError but its .reason is a
        # string, so the refused-connection probe below would misread a
        # 500-ing peer as merely stale.
        hard = isinstance(err, (ConnectionRefusedError, FleetScrapeError,
                                urllib.error.HTTPError))
        if isinstance(err, urllib.error.URLError):
            hard = hard or isinstance(err.reason, ConnectionRefusedError)
        if hard:
            return "down"
        if peer.last_ok_t is not None \
                and (now - peer.last_ok_t) <= self.stale_after_s:
            return "stale"
        return "down"

    def _scrape_peer(self, peer: _Peer) -> None:
        t0 = time.perf_counter()
        now = time.time()
        try:
            samples = parse_prometheus(self._fetch(peer.addr, peer.name))
        except Exception as e:  # noqa: BLE001 — classified, never fatal
            state = self._classify_failure(peer, e, now)
            with self._lock:
                peer.errors += 1
                peer.last_err = f"{type(e).__name__}: {e}"
                peer.state = state
                if state == "down":
                    peer.samples = {}
            self._m_scrapes.inc(outcome="error")
            logger.debug("fleet: peer %s scrape failed (%s) -> %s",
                         peer.name, peer.last_err, state)
        else:
            with self._lock:
                peer.ok += 1
                peer.last_ok_t = now
                peer.last_err = None
                peer.state = "up"
                peer.samples = samples
            self._m_scrapes.inc(outcome="ok")
        self._m_scrape.observe(time.perf_counter() - t0, peer=peer.name)

    def scrape_once(self) -> dict:
        """One scrape round over every registered peer; returns the fleet
        view (:meth:`view`).  Peers are scraped CONCURRENTLY (one thread
        each) so the round's wall time is the slowest single peer's
        deadline, not the sum — N hung peers cost one ``timeout_s``, not
        N.  A failing or malformed peer is classified and skipped — this
        method never raises on peer behavior."""
        with self._lock:
            peers = list(self._peers.values())
        if len(peers) <= 1:
            for peer in peers:
                self._scrape_peer(peer)
        else:
            threads = [
                threading.Thread(
                    target=self._scrape_peer, args=(peer,),
                    name=f"dtf-fleet-scrape-{peer.name}", daemon=True,
                )
                for peer in peers
            ]
            for t in threads:
                t.start()
            # http_get's hard deadline bounds every worker; the extra
            # grace only covers scheduling jitter.
            join_deadline = (
                time.monotonic() + min(self.timeout_s, self.interval_s)
                + 1.0
            )
            for t in threads:
                t.join(timeout=max(join_deadline - time.monotonic(), 0.05))
        self._remerge()
        with self._lock:
            self._rounds += 1
        self._export_gauges()
        self._persist()
        return self.view()

    def _remerge(self) -> None:
        with self._lock:
            live = {
                p.name: p.samples for p in self._peers.values()
                if p.state in ("up", "stale") and p.samples
            }
        merged = merge_samples(live)
        worst: dict | None = None
        for key in self.straggler_keys:
            entry = merged.get(key)
            if entry is None or entry["n"] < 2:
                continue
            ratio = _spread(entry)
            if worst is None or ratio > worst["ratio"]:
                worst = {
                    "key": key,
                    "ratio": ratio,
                    "peer": entry["max_peer"],
                    "straggling": ratio >= self.spread_threshold,
                }
        with self._lock:
            self._merged = merged
            self._worst_spread = worst

    def _export_gauges(self) -> None:
        counts = dict.fromkeys(PEER_STATES, 0)
        with self._lock:
            for p in self._peers.values():
                counts[p.state] = counts.get(p.state, 0) + 1
        for state in PEER_STATES:
            self._m_peers.set(counts[state], state=state)

    # -- read ----------------------------------------------------------------

    def view(self) -> dict:
        """JSON-safe fleet view: peers + merged metrics + straggler."""
        now = time.time()
        with self._lock:
            peers = {
                p.name: {
                    "addr": p.addr,
                    "state": p.state,
                    "age_s": (round(now - p.last_ok_t, 3)
                              if p.last_ok_t is not None else None),
                    "ok": p.ok,
                    "errors": p.errors,
                    "last_error": p.last_err,
                }
                for p in self._peers.values()
            }
            merged = {
                k: dict(v) for k, v in self._merged.items()
            }
            worst = dict(self._worst_spread) if self._worst_spread else None
            rounds = self._rounds
        states = dict.fromkeys(PEER_STATES, 0)
        for p in peers.values():
            states[p["state"]] = states.get(p["state"], 0) + 1
        return {
            "t": now,
            "interval_s": self.interval_s,
            "scrape_rounds": rounds,
            "peers": peers,
            "states": states,
            "worst_spread": worst,
            "metrics": merged,
        }

    def _persist(self) -> None:
        """Write the small fleet snapshot (no full metric dump — /fleetz
        serves that live) to <logdir>/fleet.json, atomically.  Never
        raises: a full disk must not kill the scrape loop."""
        if not self.logdir:
            return
        view = self.view()
        doc = {
            "t": view["t"],
            "interval_s": view["interval_s"],
            "scrape_rounds": view["scrape_rounds"],
            "peers": view["peers"],
            "states": view["states"],
            "worst_spread": view["worst_spread"],
            "metrics_merged": len(view["metrics"]),
        }
        path = os.path.join(self.logdir, "fleet.json")
        try:
            os.makedirs(self.logdir, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=2)
                f.write("\n")
            os.replace(tmp, path)
        except OSError:
            logger.exception("fleet snapshot write to %s failed", path)

    # -- /fleetz -------------------------------------------------------------

    def _render_text(self, metric_filter: str | None = None) -> str:
        view = self.view()
        s = view["states"]
        lines = [
            f"fleet: {len(view['peers'])} peer(s) — {s['up']} up, "
            f"{s['stale']} stale, {s['down']} down "
            f"(scrape interval {view['interval_s']:g}s, "
            f"{view['scrape_rounds']} round(s))",
        ]
        width = max((len(n) for n in view["peers"]), default=0)
        for name, p in sorted(view["peers"].items()):
            age = f"age {p['age_s']:.1f}s" if p["age_s"] is not None \
                else "never scraped"
            err = f"  [{p['last_error']}]" if p["last_error"] else ""
            lines.append(
                f"  {name:<{width}}  {p['addr']:<21} {p['state']:<6} "
                f"{age}  ok {p['ok']} err {p['errors']}{err}"
            )
        worst = view["worst_spread"]
        if worst is not None:
            flag = "  ** STRAGGLER **" if worst["straggling"] else ""
            lines.append(
                f"worst spread: {worst['ratio']:.2f}x on {worst['key']} "
                f"(peer {worst['peer']}){flag}"
            )
        keys = sorted(view["metrics"])
        if metric_filter:
            keys = [k for k in keys if metric_filter in k]
            lines.append(f"merged metrics matching {metric_filter!r}: "
                         f"{len(keys)}")
            for k in keys[:200]:
                e = view["metrics"][k]
                lines.append(
                    f"  {k}  min {e['min']:.6g}  median {e['median']:.6g}  "
                    f"max {e['max']:.6g}  sum {e['sum']:.6g}  "
                    f"n {int(e['n'])}"
                )
        else:
            lines.append(
                f"merged metrics: {len(keys)} key(s) "
                "(?json for the full view, ?metric=<substr> to filter)"
            )
        return "\n".join(lines) + "\n"

    def fleetz(self, query: str = "") -> tuple[int, object]:
        """``GET /fleetz`` handler (the StatusServer extra-route shape):
        text by default, the full JSON view with ``?json``, a filtered
        text table with ``?metric=<substr>``."""
        from urllib.parse import parse_qs

        params = parse_qs(query or "", keep_blank_values=True)
        if "json" in params or params.get("format") == ["json"]:
            return 200, self.view()
        metric = (params.get("metric") or [None])[0]
        return 200, self._render_text(metric)

    def install(self, server) -> "FleetAggregator":
        """Register ``GET /fleetz`` on a :class:`obs.server.StatusServer`."""
        server.routes[("GET", "/fleetz")] = self.fleetz
        return self

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "FleetAggregator":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="dtf-fleet-aggregator", daemon=True
            )
            self._thread.start()
            logger.info(
                "fleet aggregator: scraping %d peer(s) every %.1fs",
                len(self._peers), self.interval_s,
            )
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.scrape_once()
            except Exception:  # pragma: no cover - belt and braces
                logger.exception("fleet scrape round failed")

    def stop(self) -> None:
        """Stop the loop and persist one final snapshot."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self._persist()

    def __enter__(self) -> "FleetAggregator":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
