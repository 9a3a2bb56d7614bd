"""Resilient RPC substrate: deadlines, retries, reconnection, breakers.

Twin of ``distributedtensorflow_tpu/net/rpc.py``, framework-free and copied
whole.  Of the transports named below the port has the data service
(``data/service.py``), the fleet ``/varz`` scrapes (``obs/fleet.py``),
the alert webhook (``obs/alerts.py``) and the serve HTTP path; the MPMD
links wait for their module, and the endpoint prefixes stay the
reference's, so ``tools/check_metrics_schema.py`` gates the port's labels
as it gates the JAX package's.

Every cross-process byte in this codebase rides one of four transports —
data-service RPCs/streams (``data/service.py``), MPMD pipeline links
(``parallel/pipeline_mpmd.py``), fleet ``/varz`` scrapes (``obs/fleet.py``)
and the serve HTTP path — and before this module each of them treated a
transient network fault as a hard failure.  This is the shared substrate
they all route through instead:

- **per-call deadlines with propagation**: a :class:`Deadline` bounds the
  whole call (connect + send + recv + every retry), and the *remaining*
  budget is stamped into the request frame as ``deadline_s`` so the
  server can bound its own work / downstream calls by the caller's
  actual patience (:func:`remaining_from_request`);
- **bounded retries with exponential backoff + jitter**
  (:class:`RetryPolicy`, :func:`backoff_s`): transport-level failures
  (refused/severed/timed out) retry until the attempt budget or the
  deadline runs out — application-level refusals (``ok: false``) are
  returned, never retried;
- **transparent reconnection for persistent streams**:
  :func:`connect_stream` dials with the same backoff/deadline machinery,
  registers the socket so chaos can sever it (:func:`sever_streams`),
  and the owning stream protocol resumes exactly-once via its own resume
  token (see ``data/service.py``'s ``sid`` contract);
- **per-endpoint circuit breakers** (:mod:`net.breaker`): a persistently
  dead endpoint fails fast locally instead of burning a full timeout per
  call; the half-open probe re-closes it when the peer returns.

Wire format: unchanged from the data-service v1 protocol — every frame is
``uint64 LE length + payload``; a request/response is one JSON frame
optionally followed by one binary frame (``has_data``).  The framing
primitives live HERE now (``data/service.py`` re-exports them) so the
substrate has no dependency on any one transport.

Telemetry (the obs registry):
``rpc_retries_total{endpoint,outcome}`` (every retried attempt, by
whether the retry succeeded), ``rpc_deadline_exceeded_total{endpoint}``,
``rpc_attempt_seconds{endpoint}`` per-attempt wall histograms, plus the
``breaker_*`` family from :mod:`net.breaker`.

Chaos hooks (``resilience/chaos.py`` ``net_*`` fault kinds): faults are
armed process-locally with :func:`arm_fault` (``net_delay`` /
``net_drop`` credit-bounded against matching endpoints) or injected
immediately with :func:`sever_streams`; the first successful matching
call after a fault's credits are spent fires its ``on_recovered``
callback — that is what pairs the ``recovered`` row in ``faults.jsonl``.

Endpoint identities are low-cardinality strings naming the failure
domain: ``"dispatcher"``, ``"data_worker:<addr>"``, ``"mpmd_link:<i>"``,
``"fleet_peer:<name>"``.  The prefix before the first ``:`` must come
from :data:`ENDPOINT_PREFIXES` — ``tools/check_metrics_schema.py`` gates
the exported label values against it.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import logging
import random
import socket
import threading
import time

from ..obs.registry import counter as _counter
from ..obs.registry import histogram as _histogram
from .breaker import breaker_for

logger = logging.getLogger(__name__)

__all__ = [
    "Deadline",
    "DeadlineExceeded",
    "ENDPOINT_PREFIXES",
    "RetryPolicy",
    "arm_fault",
    "backoff_s",
    "call",
    "clear_faults",
    "connect_stream",
    "connect_with_retry",
    "http_get",
    "http_post",
    "note_success",
    "recv_frame",
    "recv_msg",
    "register_stream",
    "remaining_from_request",
    "send_frame",
    "send_msg",
    "sever_streams",
    "unregister_stream",
    "watch_recovery",
]

#: Known endpoint-identity prefixes (the part before the first ``:``).
#: The schema checker mirrors this tuple — a typo'd endpoint label would
#: silently fork every ``rpc_*`` time series.
ENDPOINT_PREFIXES = (
    "dispatcher", "data_worker", "mpmd_link", "fleet_peer", "serve",
    "peer", "webhook",
)

#: ``rpc_retries_total`` outcome label values (mirrored by the checker).
RETRY_OUTCOMES = ("ok", "error")

_M_RETRIES = _counter(
    "rpc_retries_total",
    "retried RPC attempts by endpoint and retry outcome",
)
_M_DEADLINE = _counter(
    "rpc_deadline_exceeded_total",
    "RPC calls abandoned at their deadline, by endpoint",
)
_H_ATTEMPT = _histogram(
    "rpc_attempt_seconds",
    "wall time of one RPC attempt (connect+send+recv), by endpoint",
)


class DeadlineExceeded(OSError):
    """The call's total wall budget ran out (connect, retry backoff, or
    response wait).  Subclasses ``OSError`` so every existing transport
    fault policy handles it like the timeout it is."""

    def __init__(self, message: str, *, endpoint: str = ""):
        super().__init__(message)
        self.endpoint = endpoint


class Deadline:
    """Absolute wall-clock budget carried through one logical operation."""

    __slots__ = ("_t_end",)

    def __init__(self, seconds: float):
        self._t_end = time.monotonic() + float(seconds)

    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        return cls(seconds)

    def remaining(self) -> float:
        return self._t_end - time.monotonic()

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry/deadline shape of one call family.

    ``deadline_s`` bounds the WHOLE call including backoff sleeps;
    ``max_attempts`` bounds transport-level retries (1 = no retry);
    backoff for attempt ``k`` (0-based retry index) is
    ``min(backoff_base_s * 2**k, backoff_max_s)`` stretched by a
    uniform jitter in ``[1 - jitter, 1 + jitter]``.
    """

    deadline_s: float = 30.0
    max_attempts: int = 4
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    jitter: float = 0.5
    connect_timeout_s: float = 5.0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got "
                             f"{self.max_attempts}")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")


DEFAULT_POLICY = RetryPolicy()
#: Single-shot policy for callers with their own outer retry loop.
ONESHOT_POLICY = RetryPolicy(max_attempts=1)


def backoff_s(policy: RetryPolicy, retry_index: int,
              rng: random.Random | None = None) -> float:
    """Backoff before retry ``retry_index`` (0-based): capped exponential
    with multiplicative jitter.  Pass a seeded ``rng`` for a reproducible
    schedule (tests; chaos determinism)."""
    base = min(
        policy.backoff_base_s * (2.0 ** retry_index), policy.backoff_max_s
    )
    if policy.jitter <= 0.0:
        return base
    r = rng if rng is not None else random
    return base * (1.0 + policy.jitter * (2.0 * r.random() - 1.0))


def remaining_from_request(req: dict) -> float | None:
    """The caller's remaining deadline budget a request frame carries
    (``deadline_s``, stamped by :func:`call`), or None.  Servers use it
    to bound their own work — honoring a deadline end-to-end means never
    working past the moment the caller stopped listening."""
    v = req.get("deadline_s")
    if isinstance(v, bool) or not isinstance(v, (int, float)) or v < 0:
        return None
    return float(v)


# --- framing (the shared length-prefixed JSON[+binary] wire) -----------------


def send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(len(payload).to_bytes(8, "little") + payload)


def recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def recv_frame(sock: socket.socket) -> bytes:
    n = int.from_bytes(recv_exact(sock, 8), "little")
    if n > (1 << 31):
        raise ConnectionError(f"oversized frame ({n} bytes)")
    return recv_exact(sock, n)


def send_msg(sock: socket.socket, header: dict,
             data: bytes | None = None) -> None:
    header = dict(header, has_data=data is not None)
    send_frame(sock, json.dumps(header).encode())
    if data is not None:
        send_frame(sock, data)


def recv_msg(sock: socket.socket) -> tuple[dict, bytes | None]:
    header = json.loads(recv_frame(sock))
    data = recv_frame(sock) if header.get("has_data") else None
    return header, data


# --- chaos fault injection ---------------------------------------------------


class _Fault:
    __slots__ = ("kind", "match", "calls", "delay_s", "on_recovered",
                 "exhausted")

    def __init__(self, kind, match, calls, delay_s, on_recovered):
        self.kind = kind
        self.match = match
        self.calls = calls
        self.delay_s = delay_s
        self.on_recovered = on_recovered
        self.exhausted = calls is not None and calls <= 0


_FAULTS: list[_Fault] = []
_FAULTS_LOCK = threading.Lock()
#: Live persistent-stream sockets by id: (socket, endpoint).
_STREAMS: dict[int, tuple[socket.socket, str]] = {}
_STREAMS_LOCK = threading.Lock()
_STREAM_IDS = iter(range(1, 1 << 62))


def arm_fault(kind: str, *, calls: int = 1, delay_s: float = 0.0,
              match: str = "", on_recovered=None) -> None:
    """Arm a deterministic transport fault against the next ``calls``
    attempts whose endpoint contains ``match`` (chaos hook):

    - ``net_delay``: sleep ``delay_s`` before the attempt proceeds;
    - ``net_drop``: fail the attempt with ``ConnectionError`` before any
      byte is sent.

    Once the credits are spent, the first successful matching attempt
    fires ``on_recovered()`` (exactly once) — proof the transport
    absorbed the fault.
    """
    if kind not in ("net_delay", "net_drop"):
        raise ValueError(f"unknown net fault kind {kind!r}")
    with _FAULTS_LOCK:
        _FAULTS.append(_Fault(kind, match, int(calls), float(delay_s),
                              on_recovered))


def watch_recovery(match: str = "", on_recovered=None) -> None:
    """Fire ``on_recovered()`` on the next successful matching attempt
    (used by ``net_sever``, whose injection is immediate)."""
    with _FAULTS_LOCK:
        f = _Fault("watch", match, None, 0.0, on_recovered)
        f.exhausted = True
        _FAULTS.append(f)


def clear_faults() -> None:
    """Drop every armed fault/watch (test isolation)."""
    with _FAULTS_LOCK:
        _FAULTS.clear()


def _apply_faults(endpoint: str) -> None:
    """Consume one credit of every armed fault matching ``endpoint``;
    sleeps (delay) happen outside the lock, drops raise."""
    delay = 0.0
    drop = False
    with _FAULTS_LOCK:
        for f in _FAULTS:
            if f.exhausted or f.match not in endpoint:
                continue
            f.calls -= 1
            if f.calls <= 0:
                f.exhausted = True
            if f.kind == "net_delay":
                delay = max(delay, f.delay_s)
            elif f.kind == "net_drop":
                drop = True
    if delay > 0.0:
        time.sleep(delay)
    if drop:
        raise ConnectionError(f"chaos: dropped rpc to {endpoint}")


def note_success(endpoint: str) -> None:
    """Record a successful attempt against ``endpoint``: exhausted
    matching faults fire their recovery callback and retire."""
    fired = []
    with _FAULTS_LOCK:
        keep = []
        for f in _FAULTS:
            if f.exhausted and f.match in endpoint:
                if f.on_recovered is not None:
                    fired.append(f.on_recovered)
            else:
                keep.append(f)
        _FAULTS[:] = keep
    for cb in fired:
        try:
            cb()
        except Exception:  # pragma: no cover - chaos bookkeeping only
            logger.exception("net fault recovery callback failed")


def register_stream(sock: socket.socket, endpoint: str) -> int:
    """Track a live persistent-stream socket (chaos sever target).
    Returns a token for :func:`unregister_stream`."""
    sid = next(_STREAM_IDS)
    with _STREAMS_LOCK:
        _STREAMS[sid] = (sock, endpoint)
    return sid


def unregister_stream(token: int) -> None:
    with _STREAMS_LOCK:
        _STREAMS.pop(token, None)


def sever_streams(match: str = "") -> int:
    """Forcibly shut down every registered stream whose endpoint contains
    ``match`` (the ``net_sever`` chaos kind).  Returns how many were
    severed; the owners see a ``ConnectionError`` and reconnect through
    their resume protocol."""
    with _STREAMS_LOCK:
        doomed = [(t, s, e) for t, (s, e) in _STREAMS.items()
                  if match in e]
    n = 0
    for token, sock, _endpoint in doomed:
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass
        unregister_stream(token)
        n += 1
    return n


# --- unary call --------------------------------------------------------------


def _split_addr(addr: str) -> tuple[str, int]:
    host, port = addr.rsplit(":", 1)
    return host, int(port)


def call(
    addr: str,
    request: dict,
    *,
    endpoint: str | None = None,
    policy: RetryPolicy = DEFAULT_POLICY,
    deadline_s: float | None = None,
    trace: dict | None = None,
    breaker=None,
    rng: random.Random | None = None,
) -> tuple[dict, bytes | None]:
    """One resilient unary RPC: connect, send one JSON frame, read one
    JSON[+binary] response.

    The request frame is stamped with the remaining ``deadline_s`` (and
    the ``trace`` context when given).  Transport failures retry under
    ``policy``; the endpoint's circuit breaker is consulted before every
    attempt and fed after it.  Application-level refusals (a response
    with ``ok: false``) are RETURNED — only the transport retries.

    Raises :class:`DeadlineExceeded` when the budget runs out,
    :class:`~net.breaker.BreakerOpenError` when the breaker fails fast,
    or the last transport error once ``max_attempts`` is spent.
    """
    endpoint = endpoint or addr
    br = breaker if breaker is not None else breaker_for(endpoint)
    dl = Deadline(policy.deadline_s if deadline_s is None else deadline_s)
    host, port = _split_addr(addr)
    if trace:
        request = dict(request, trace=trace)
    last_err: BaseException | None = None
    for attempt in range(policy.max_attempts):
        br.check()
        t0 = time.perf_counter()
        try:
            _apply_faults(endpoint)
            remaining = dl.remaining()
            if remaining <= 0:
                raise DeadlineExceeded(
                    f"rpc to {endpoint} out of budget before attempt "
                    f"{attempt}", endpoint=endpoint,
                )
            with socket.create_connection(
                (host, port),
                timeout=min(policy.connect_timeout_s, remaining),
            ) as s:
                s.settimeout(max(dl.remaining(), 1e-3))
                send_msg(s, dict(request,
                                 deadline_s=round(max(dl.remaining(), 0.0),
                                                  3)))
                resp = recv_msg(s)
        except (OSError, ConnectionError, socket.timeout,
                json.JSONDecodeError) as e:
            _H_ATTEMPT.observe(time.perf_counter() - t0, endpoint=endpoint)
            br.record_failure()
            if attempt > 0:
                _M_RETRIES.inc(endpoint=endpoint, outcome="error")
            if isinstance(e, DeadlineExceeded) or dl.expired:
                _M_DEADLINE.inc(endpoint=endpoint)
                if isinstance(e, DeadlineExceeded):
                    raise
                raise DeadlineExceeded(
                    f"rpc to {endpoint} exceeded its deadline "
                    f"({type(e).__name__}: {e})", endpoint=endpoint,
                ) from e
            last_err = e
            if attempt + 1 >= policy.max_attempts:
                raise
            delay = backoff_s(policy, attempt, rng)
            if dl.remaining() <= delay:
                _M_DEADLINE.inc(endpoint=endpoint)
                raise DeadlineExceeded(
                    f"rpc to {endpoint}: deadline leaves no room for "
                    f"retry backoff ({delay:.3f}s)", endpoint=endpoint,
                ) from e
            time.sleep(delay)
            continue
        _H_ATTEMPT.observe(time.perf_counter() - t0, endpoint=endpoint)
        br.record_success()
        note_success(endpoint)
        if attempt > 0:
            _M_RETRIES.inc(endpoint=endpoint, outcome="ok")
        return resp
    raise last_err if last_err is not None else RuntimeError("unreachable")


# --- persistent streams ------------------------------------------------------


def connect_with_retry(
    factory,
    *,
    endpoint: str,
    deadline_s: float,
    policy: RetryPolicy = DEFAULT_POLICY,
    retryable: tuple = (OSError, ValueError),
    breaker=None,
    rng: random.Random | None = None,
):
    """Run ``factory()`` (any connect-shaped callable) under the backoff/
    deadline/breaker machinery until it returns, a non-retryable error
    escapes, or the deadline expires (:class:`DeadlineExceeded`).  Unlike
    :func:`call` there is no attempt cap — rendezvous loops (MPMD links,
    worker startup) legitimately outwait a peer's whole respawn — and an
    OPEN breaker paces the dialing (wait out the cooldown, then probe)
    instead of failing the loop: fast-fail is for unary callers with
    somewhere else to go, which a rendezvous does not have."""
    br = breaker if breaker is not None else breaker_for(endpoint)
    dl = Deadline(deadline_s)
    retry_index = 0
    while True:
        while not br.allow():
            if dl.remaining() <= 0.05:
                _M_DEADLINE.inc(endpoint=endpoint)
                raise DeadlineExceeded(
                    f"connect to {endpoint}: deadline expired waiting "
                    "out the open breaker", endpoint=endpoint,
                )
            time.sleep(0.05)
        t0 = time.perf_counter()
        try:
            _apply_faults(endpoint)
            result = factory()
        except retryable as e:
            _H_ATTEMPT.observe(time.perf_counter() - t0, endpoint=endpoint)
            br.record_failure()
            if retry_index > 0:
                _M_RETRIES.inc(endpoint=endpoint, outcome="error")
            delay = backoff_s(policy, retry_index, rng)
            retry_index += 1
            if dl.remaining() <= delay:
                _M_DEADLINE.inc(endpoint=endpoint)
                raise DeadlineExceeded(
                    f"connect to {endpoint} failed for {deadline_s:.0f}s "
                    f"({type(e).__name__}: {e})", endpoint=endpoint,
                ) from e
            time.sleep(delay)
            continue
        _H_ATTEMPT.observe(time.perf_counter() - t0, endpoint=endpoint)
        br.record_success()
        note_success(endpoint)
        if retry_index > 0:
            _M_RETRIES.inc(endpoint=endpoint, outcome="ok")
        return result


def connect_stream(
    addr: str,
    *,
    endpoint: str,
    timeout_s: float,
    connect_deadline_s: float | None = None,
    policy: RetryPolicy = DEFAULT_POLICY,
) -> tuple[socket.socket, int]:
    """Dial a persistent stream with retry/backoff/breaker, register it
    as a chaos sever target, and return ``(socket, token)``.  The caller
    owns the socket and must :func:`unregister_stream` the token on
    close.  ``timeout_s`` becomes the socket's per-op timeout."""
    host, port = _split_addr(addr)

    def _dial():
        s = socket.create_connection(
            (host, port), timeout=min(policy.connect_timeout_s, timeout_s)
        )
        s.settimeout(timeout_s)
        return s

    sock = connect_with_retry(
        _dial,
        endpoint=endpoint,
        deadline_s=(connect_deadline_s if connect_deadline_s is not None
                    else policy.deadline_s),
        policy=policy,
        retryable=(OSError,),
    )
    return sock, register_stream(sock, endpoint)


# --- deadline-bounded HTTP GET (fleet scrapes) -------------------------------


def http_get(url: str, *, deadline_s: float, endpoint: str,
             max_bytes: int = 16 << 20, breaker=None) -> tuple[int, str]:
    """GET ``url`` under a HARD wall deadline: connect, headers and every
    body chunk are all charged to one :class:`Deadline`, so a peer that
    accepts and then trickles (or never sends) bytes costs at most
    ``deadline_s`` — not a per-socket-op timeout multiplied by however
    many ops it strings along.  Returns ``(status, body)``; raises
    :class:`DeadlineExceeded` / ``OSError`` on transport failure.  One
    attempt, no retry — scrape-shaped callers have their own cadence."""
    br = breaker if breaker is not None else breaker_for(endpoint)
    br.check()
    dl = Deadline(deadline_s)
    if not url.startswith("http://"):
        raise ValueError(f"http_get supports http:// urls only: {url!r}")
    hostport, _, path = url[len("http://"):].partition("/")
    host, port = _split_addr(hostport)
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection(
        host, port, timeout=max(dl.remaining(), 1e-3)
    )
    try:
        _apply_faults(endpoint)
        conn.request("GET", "/" + path)
        if conn.sock is not None:
            conn.sock.settimeout(max(dl.remaining(), 1e-3))
        resp = conn.getresponse()
        chunks: list[bytes] = []
        total = 0
        while True:
            if dl.expired:
                raise DeadlineExceeded(
                    f"scrape of {endpoint} exceeded {deadline_s:.1f}s "
                    "mid-body", endpoint=endpoint,
                )
            if conn.sock is not None:
                conn.sock.settimeout(max(min(dl.remaining(), 0.25), 1e-3))
            try:
                chunk = resp.read(65536)
            except socket.timeout:
                continue  # re-check the deadline, then keep reading
            if not chunk:
                break
            total += len(chunk)
            if total > max_bytes:
                raise DeadlineExceeded(
                    f"scrape of {endpoint} exceeded {max_bytes} bytes",
                    endpoint=endpoint,
                )
            chunks.append(chunk)
        status = resp.status
        body = b"".join(chunks).decode("utf-8", errors="replace")
    except socket.timeout as e:
        _H_ATTEMPT.observe(time.perf_counter() - t0, endpoint=endpoint)
        _M_DEADLINE.inc(endpoint=endpoint)
        br.record_failure()
        raise DeadlineExceeded(
            f"scrape of {endpoint} timed out within {deadline_s:.1f}s",
            endpoint=endpoint,
        ) from e
    except DeadlineExceeded:
        _H_ATTEMPT.observe(time.perf_counter() - t0, endpoint=endpoint)
        _M_DEADLINE.inc(endpoint=endpoint)
        br.record_failure()
        raise
    except (OSError, http.client.HTTPException):
        _H_ATTEMPT.observe(time.perf_counter() - t0, endpoint=endpoint)
        br.record_failure()
        raise
    finally:
        conn.close()
    _H_ATTEMPT.observe(time.perf_counter() - t0, endpoint=endpoint)
    br.record_success()
    note_success(endpoint)
    return status, body


def http_post(
    url: str,
    payload: dict,
    *,
    endpoint: str,
    policy: RetryPolicy = DEFAULT_POLICY,
    deadline_s: float | None = None,
    breaker=None,
    rng: random.Random | None = None,
) -> tuple[int, str]:
    """POST ``payload`` as JSON under the full unary machinery — the
    deadline bounds connect + send + response + backoff sleeps, transport
    failures retry under ``policy``, the endpoint's breaker is consulted
    before and fed after every attempt, and armed chaos faults apply
    (webhook delivery is chaos-testable like any RPC).  A 5xx status is a
    transport-shaped failure (the receiver exists but is broken) and
    retries; any other status is RETURNED as ``(status, body)``.  Raises
    :class:`DeadlineExceeded` / :class:`~net.breaker.BreakerOpenError` /
    the last transport error like :func:`call`."""
    br = breaker if breaker is not None else breaker_for(endpoint)
    dl = Deadline(policy.deadline_s if deadline_s is None else deadline_s)
    if not url.startswith("http://"):
        raise ValueError(f"http_post supports http:// urls only: {url!r}")
    hostport, _, path = url[len("http://"):].partition("/")
    host, port = _split_addr(hostport)
    body = json.dumps(payload).encode("utf-8")
    last_err: BaseException | None = None
    for attempt in range(policy.max_attempts):
        br.check()
        t0 = time.perf_counter()
        conn = None
        try:
            _apply_faults(endpoint)
            remaining = dl.remaining()
            if remaining <= 0:
                raise DeadlineExceeded(
                    f"post to {endpoint} out of budget before attempt "
                    f"{attempt}", endpoint=endpoint,
                )
            conn = http.client.HTTPConnection(
                host, port,
                timeout=min(policy.connect_timeout_s, remaining),
            )
            conn.request(
                "POST", "/" + path, body=body,
                headers={"Content-Type": "application/json"},
            )
            if conn.sock is not None:
                conn.sock.settimeout(max(dl.remaining(), 1e-3))
            resp = conn.getresponse()
            text = resp.read(1 << 20).decode("utf-8", errors="replace")
            if resp.status >= 500:
                raise OSError(
                    f"webhook {endpoint} answered {resp.status}")
            status = resp.status
        except (OSError, http.client.HTTPException) as e:
            _H_ATTEMPT.observe(time.perf_counter() - t0, endpoint=endpoint)
            br.record_failure()
            if attempt > 0:
                _M_RETRIES.inc(endpoint=endpoint, outcome="error")
            if isinstance(e, DeadlineExceeded) or dl.expired:
                _M_DEADLINE.inc(endpoint=endpoint)
                if isinstance(e, DeadlineExceeded):
                    raise
                raise DeadlineExceeded(
                    f"post to {endpoint} exceeded its deadline "
                    f"({type(e).__name__}: {e})", endpoint=endpoint,
                ) from e
            last_err = e
            if attempt + 1 >= policy.max_attempts:
                raise
            delay = backoff_s(policy, attempt, rng)
            if dl.remaining() <= delay:
                _M_DEADLINE.inc(endpoint=endpoint)
                raise DeadlineExceeded(
                    f"post to {endpoint}: deadline leaves no room for "
                    f"retry backoff ({delay:.3f}s)", endpoint=endpoint,
                ) from e
            time.sleep(delay)
            continue
        finally:
            if conn is not None:
                conn.close()
        _H_ATTEMPT.observe(time.perf_counter() - t0, endpoint=endpoint)
        br.record_success()
        note_success(endpoint)
        if attempt > 0:
            _M_RETRIES.inc(endpoint=endpoint, outcome="ok")
        return status, text
    raise last_err if last_err is not None else RuntimeError("unreachable")
