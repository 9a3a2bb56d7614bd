"""The port's resilient RPC substrate (``net/``) against the JAX package's.

The same seeded ``random.Random`` gives the same backoff schedule; the
same bad policies raise the same errors; the same scripted clock drives
both circuit breakers through the same states; ``call`` speaks the same
wire (each package's client against the other's framing) and absorbs the
same armed drops with the same retry counts; ``http_post`` delivers the
same JSON body to an in-thread loopback webhook and retries a 5xx the
same way; and ``ENDPOINT_PREFIXES`` is the schema checker's list.
Loopback threads only, no processes.
"""

import json
import random
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from distributedtensorflow_tpu.net import breaker as jax_breaker
from distributedtensorflow_tpu.net import rpc as jax_rpc
from distributedtensorflow_tpu_torch.net import breaker, rpc
from tools import check_metrics_schema

PACKAGES = {"jax": (jax_breaker, jax_rpc), "torch": (breaker, rpc)}


@pytest.fixture(autouse=True)
def _net_isolation():
    """Breakers and armed faults are process-global in each package."""
    for br, r in PACKAGES.values():
        br.reset_breakers()
        r.clear_faults()
    yield
    for br, r in PACKAGES.values():
        br.reset_breakers()
        r.clear_faults()


POLICIES = {
    "default": {},
    "no_jitter": {"jitter": 0.0, "backoff_base_s": 0.1},
    "capped": {"backoff_base_s": 0.5, "backoff_max_s": 1.0, "jitter": 0.9},
}


@pytest.mark.parametrize("case", sorted(POLICIES))
def test_backoff_schedule_matches_jax(case):
    got = [rpc.backoff_s(rpc.RetryPolicy(**POLICIES[case]), i,
                         random.Random(5)) for i in range(8)]
    want = [jax_rpc.backoff_s(jax_rpc.RetryPolicy(**POLICIES[case]), i,
                              random.Random(5)) for i in range(8)]
    assert got == want


@pytest.mark.parametrize("bad", [{"max_attempts": 0}, {"jitter": 1.0},
                                 {"jitter": -0.1}])
def test_retry_policy_validation_matches_jax(bad):
    errors = []
    for mod in (rpc, jax_rpc):
        with pytest.raises(ValueError) as e:
            mod.RetryPolicy(**bad)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


#: (operation, clock advance) script of one breaker's life.
BREAKER_SCRIPT = (
    ("fail", 0), ("fail", 0), ("success", 0), ("fail", 0), ("fail", 0),
    ("fail", 0), ("allow", 0), ("allow", 1.5), ("allow", 0.6),
    ("allow", 0), ("fail", 0), ("allow", 1.0), ("allow", 1.1),
    ("success", 0), ("allow", 0), ("fail", 0),
)


def test_breaker_state_machine_matches_jax():
    """The same script under the same clock: the same answers of
    ``allow`` and the same state after every event."""
    traces = {}
    for pkg, (br, _) in PACKAGES.items():
        clock = Clock()
        b = br.CircuitBreaker(f"peer:{pkg}", failure_threshold=3,
                              open_for_s=2.0, clock=clock)
        trace = []
        for op, dt in BREAKER_SCRIPT:
            clock.t += dt
            if op == "fail":
                b.record_failure()
            elif op == "success":
                b.record_success()
            else:
                trace.append(b.allow())
            trace.append(b.state)
        traces[pkg] = trace
    assert traces["torch"] == traces["jax"]
    assert {"open", "half_open", "closed"} <= set(traces["torch"])


class _EchoServer:
    """Loopback server on one package's framing; echoes the request
    header.  ``hang_s``: wait that long before answering."""

    def __init__(self, framing, hang_s: float = 0.0):
        self._framing, self._hang = framing, hang_s
        self._srv = socket.socket()
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(8)
        self.addr = f"127.0.0.1:{self._srv.getsockname()[1]}"
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while True:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            try:
                req, _ = self._framing.recv_msg(conn)
                time.sleep(self._hang)
                self._framing.send_msg(conn, {"ok": True, "echo": req},
                                       b"\x01\x02")
            except OSError:
                pass
            finally:
                conn.close()

    def close(self):
        self._srv.close()


@pytest.mark.parametrize("client,server", [("torch", "jax"),
                                           ("jax", "torch")])
def test_call_absorbs_drops_across_packages(client, server):
    """Two armed drops, then an answer over the other package's framing:
    the same response, two retries recorded, the recovery callback."""
    _, cli = PACKAGES[client]
    srv = _EchoServer(PACKAGES[server][1])
    recovered = threading.Event()
    try:
        ep = f"peer:drops_{client}"
        cli.arm_fault("net_drop", calls=2, match=ep,
                      on_recovered=recovered.set)
        before = cli._M_RETRIES.value(endpoint=ep, outcome="ok")
        resp, data = cli.call(
            srv.addr, {"kind": "ping"}, endpoint=ep,
            policy=cli.RetryPolicy(deadline_s=10.0, max_attempts=4,
                                   backoff_base_s=0.01, jitter=0.0))
        assert resp["ok"] and resp["echo"]["kind"] == "ping"
        assert data == b"\x01\x02"
        assert 0.0 < resp["echo"]["deadline_s"] <= 10.0
        assert cli._M_RETRIES.value(endpoint=ep, outcome="ok") == before + 1
        assert recovered.is_set()
    finally:
        srv.close()


def test_call_deadline_on_a_hung_server_as_jax():
    out = {}
    for pkg, (_, mod) in PACKAGES.items():
        srv = _EchoServer(mod, hang_s=1.0)
        try:
            t0 = time.monotonic()
            with pytest.raises(mod.DeadlineExceeded):
                mod.call(srv.addr, {"kind": "ping"}, endpoint="peer:hung",
                         policy=mod.RetryPolicy(deadline_s=0.3,
                                                max_attempts=1))
            out[pkg] = time.monotonic() - t0 < 0.9
        finally:
            srv.close()
    assert out == {"jax": True, "torch": True}


class _Hook(BaseHTTPRequestHandler):
    fail_first = 0
    bodies: list = []

    def do_POST(self):  # noqa: N802 - http.server contract
        body = self.rfile.read(int(self.headers["Content-Length"]))
        type(self).bodies.append(json.loads(body))
        if type(self).fail_first > 0:
            type(self).fail_first -= 1
            self.send_response(503)
        else:
            self.send_response(200)
        self.end_headers()
        self.wfile.write(b"ok")

    def log_message(self, *args):
        pass


@pytest.fixture
def webhook():
    handler = type("Hook", (_Hook,), {"bodies": [], "fail_first": 0})
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield handler, f"http://127.0.0.1:{srv.server_address[1]}/hook"
    srv.shutdown()
    srv.server_close()


def test_http_post_to_a_loopback_webhook_as_jax(webhook):
    """One 503 then 200, for each package: the same status, body and
    retry, and the receiver saw the same JSON twice from each."""
    handler, url = webhook
    payload = {"rule": "ttft_high", "phase": "fired", "value": 0.25}
    got = {}
    for pkg, (_, mod) in PACKAGES.items():
        handler.fail_first = 1
        ep = f"webhook:{pkg}"
        got[pkg] = mod.http_post(
            url, payload, endpoint=ep,
            policy=mod.RetryPolicy(deadline_s=5.0, max_attempts=3,
                                   backoff_base_s=0.01, jitter=0.0))
        assert mod._M_RETRIES.value(endpoint=ep, outcome="ok") == 1
    assert got["torch"] == got["jax"] == (200, "ok")
    assert handler.bodies == [payload] * 4


def test_http_get_reads_the_port_varz():
    from distributedtensorflow_tpu_torch.obs import Registry, StatusServer

    reg = Registry()
    reg.gauge("depth").set(3.0)
    srv = StatusServer(0, registry=reg).start()
    try:
        url = f"http://127.0.0.1:{srv.port}/varz"
        got = rpc.http_get(url, deadline_s=5.0, endpoint="fleet_peer:x")
        assert got == jax_rpc.http_get(url, deadline_s=5.0,
                                       endpoint="fleet_peer:x")
        assert got[0] == 200 and "depth 3" in got[1]
    finally:
        srv.stop()


def test_endpoint_prefixes_are_the_schema_checkers():
    assert rpc.ENDPOINT_PREFIXES == jax_rpc.ENDPOINT_PREFIXES
    assert set(rpc.ENDPOINT_PREFIXES) == \
        set(check_metrics_schema.RPC_ENDPOINT_PREFIXES)
    assert breaker.BREAKER_STATES == jax_breaker.BREAKER_STATES
