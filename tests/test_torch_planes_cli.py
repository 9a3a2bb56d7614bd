"""The operations planes through the port's entry points, on the CPU.

``train_torch.main`` at test size with ``--dynamics-every 1``,
``--status-port 0``, ``--fleet``, ``--slo-rules`` and ``--alert-rules``
writes ``dynamics.jsonl``, ``history.jsonl``, ``alerts.jsonl`` and
``fleet.json``, which ``tools/check_metrics_schema.py`` (called in
process) accepts, and answers ``/dynamicz``, ``/fleetz``, ``/sloz``,
``/alertz``, ``/histz`` and ``/healthz?deep=1`` while it trains.
``serve_torch.main`` with the history, SLO and alert flags pins the
tenants' usage series into ``history.jsonl``, answers ``/histz``,
``/sloz``, ``/alertz`` and ``/usagez``, and posts the firing of a rule
set to fire to a loopback webhook.  The flags' defaults are
``train.py``'s and ``serve.py``'s, read from their sources, and the
usage errors use their words.
"""

import ast
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest

import serve_torch
import train_torch
from distributedtensorflow_tpu_torch.net import breaker
from distributedtensorflow_tpu_torch.train import Callback
from tools import check_metrics_schema
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TRAIN_FLAGS = ("--dynamics-every", "--fleet", "--fleet-interval",
               "--fleet-peer", "--slo-rules", "--slo-interval",
               "--alert-rules", "--alert-interval", "--alert-webhook")
SERVE_FLAGS = ("--history-interval", "--history-points", "--slo-rules",
               "--slo-interval", "--alert-rules", "--alert-interval",
               "--alert-webhook")
PATHS = ("/dynamicz", "/fleetz", "/sloz", "/alertz", "/histz",
         "/healthz?deep=1")


def _source_defaults(path) -> dict:
    """{flag: default} of every ``add_argument`` in a script's source (a
    ``store_true`` flag defaults to False), read without importing it."""
    out = {}
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if not (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "add_argument"
                and node.args and isinstance(node.args[0], ast.Constant)):
            continue
        kw = {k.arg: k.value for k in node.keywords}
        if "default" in kw:
            out[node.args[0].value] = ast.literal_eval(kw["default"])
        elif getattr(kw.get("action"), "value", None) == "store_true":
            out[node.args[0].value] = False
        else:
            out[node.args[0].value] = None
    return out


def _dest(flag):
    return flag.lstrip("-").replace("-", "_")


def test_train_flags_default_as_train_py():
    want = _source_defaults(REPO / "train.py")
    args = train_torch.parse_args([])
    for flag in TRAIN_FLAGS:
        assert getattr(args, _dest(flag)) == want[flag], flag


def test_serve_flags_default_as_serve_py():
    want = _source_defaults(REPO / "serve.py")
    args = serve_torch.parse_args([])
    for flag in SERVE_FLAGS:
        assert getattr(args, _dest(flag)) == want[flag], flag


def _exit_message(main, argv) -> str:
    with pytest.raises(SystemExit) as e:
        main(argv)
    return str(e.value)


def test_usage_errors_use_train_py_words(tmp_path):
    source = (REPO / "train.py").read_text()
    base = ["--workload", "gpt_lm", "--test-size", "--device", "cpu",
            "--steps", "1"]
    msg = _exit_message(train_torch.main, [*base, "--fleet"])
    assert msg.startswith("--fleet requires --status-port")
    assert "--fleet requires --status-port (the aggregator serves" in source
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"alerts": [{"name": "x", "kind": "nope"}]}))
    msg = _exit_message(train_torch.main, [*base, "--alert-rules", str(bad)])
    assert msg.startswith(f"--alert-rules {bad}: {bad}: alerts[0]: 'kind'")
    assert 'raise SystemExit(f"--alert-rules {args.alert_rules}: {e}")' \
        in source
    msg = _exit_message(train_torch.main, [
        *base, "--status-port", "0", "--fleet", "--fleet-peer", "w1"])
    assert msg == "--fleet-peer 'w1': expected NAME=HOST:PORT"


class _Probe(Callback):
    """GETs PATHS from the trainer's status server at one step."""

    def __init__(self, at_step):
        self.at_step, self.answers = at_step, {}

    def on_step_end(self, trainer, step, state, metrics):
        if step != self.at_step:
            return
        for path in PATHS:
            url = f"http://127.0.0.1:{trainer.status_server.port}{path}"
            try:
                with urllib.request.urlopen(url, timeout=30) as r:
                    self.answers[path] = r.status
            except urllib.error.HTTPError as e:  # a failing deep health
                self.answers[path] = e.code


@pytest.fixture
def empty_series():
    """The default registry's series emptied for the test and put back
    after it.  Series that earlier tests of this worker process left in
    the process's registry would take the history store's ``max_series``
    slots (512; this run alone fills 276) that the run's dynamics gauges
    need.  The metric objects stay, since modules hold them from their
    import."""
    from distributedtensorflow_tpu_torch.obs import registry

    saved = []
    for metric in registry.default_registry().metrics():
        store = metric._hist if isinstance(metric, registry.Histogram) \
            else metric._values
        saved.append((store, dict(store)))
        store.clear()
    yield
    for store, items in saved:
        store.clear()
        store.update(items)


def test_train_torch_planes_write_their_logs(tmp_path, monkeypatch,
                                             empty_series):
    breaker.reset_breakers()
    probe = _Probe(3)
    make = train_torch.Trainer

    def trainer(*args, callbacks=None, **kw):
        return make(*args, callbacks=[*(callbacks or []), probe], **kw)

    monkeypatch.setattr(train_torch, "Trainer", trainer)
    logdir = tmp_path / "run"
    records = train_torch.main([
        "--workload", "gpt_lm", "--test-size", "--device", "cpu",
        "--steps", "4", "--log-every", "2", "--dynamics-every", "1",
        "--status-port", "0", "--fleet", "--fleet-interval", "0.1",
        "--slo-rules", str(REPO / "examples" / "slo_rules.json"),
        "--slo-interval", "0.1",
        "--alert-rules", str(REPO / "examples" / "alert_rules.json"),
        "--alert-interval", "0.1", "--logdir", str(logdir)])
    assert [r["step"] for r in records] == [2, 4]
    assert probe.answers["/healthz?deep=1"] in (200, 503)
    assert all(probe.answers[p] == 200 for p in PATHS[:-1]), probe.answers
    files = ["dynamics.jsonl", "history.jsonl", "alerts.jsonl",
             "fleet.json", "metrics.jsonl", "metrics.prom"]
    for name in files:
        assert (logdir / name).exists(), name
    rows = [json.loads(line) for line in
            (logdir / "dynamics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    assert sorted(rows[0]["modules"]) == ["h0", "h1", "ln_f", "wte"]
    history = (logdir / "history.jsonl").read_text()
    assert "fleet.data_batches_total.median" in history
    assert "dynamics_global_grad_norm" in history
    assert json.loads((logdir / "fleet.json").read_text())["states"][
        "up"] == 1
    assert check_metrics_schema.main(
        [str(logdir / name) for name in files]) == 0


def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generatez",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read().decode())


class _Served:
    """``serve_torch.main(argv, stop=...)`` on a thread; the port read
    from the startup line on the captured stdout."""

    def __init__(self, argv, capsys):
        self.stop, self.rc = threading.Event(), None
        self.thread = threading.Thread(target=self._run, args=(argv,))
        self.thread.start()
        out, deadline = "", time.time() + 120
        while "serving" not in out:
            assert time.time() < deadline and self.thread.is_alive(), out
            time.sleep(0.05)
            out += capsys.readouterr().out
        self.port = json.loads(out.strip().splitlines()[0])["port"]

    def _run(self, argv):
        self.rc = serve_torch.main(argv, stop=self.stop)

    def close(self):
        self.stop.set()
        self.thread.join(timeout=60)
        return self.rc


class _Hook(BaseHTTPRequestHandler):
    rows: list = []

    def do_POST(self):  # noqa: N802 - http.server contract
        body = self.rfile.read(int(self.headers["Content-Length"]))
        type(self).rows.append(json.loads(body))
        self.send_response(200)
        self.end_headers()

    def log_message(self, *args):
        pass


def test_serve_torch_planes(capsys, tmp_path):
    """Two tenants' requests; a TTFT rule set to fire posts to the
    loopback webhook; the endpoints answer; history.jsonl holds the
    tenants' pinned usage series; the logs pass the schema checker."""
    breaker.reset_breakers()
    hook = type("Hook", (_Hook,), {"rows": []})
    receiver = ThreadingHTTPServer(("127.0.0.1", 0), hook)
    threading.Thread(target=receiver.serve_forever, daemon=True).start()
    rules = tmp_path / "fire.json"
    rules.write_text(json.dumps({"alerts": [{
        "name": "ttft_high", "kind": "threshold", "severity": "page",
        "metric": "serve_ttft_seconds_avg", "op": "gt", "bound": 1e-9,
        "window_s": 60, "cooldown_s": 60}]}))
    logdir = tmp_path / "serve"
    served = _Served([
        "--config", "gpt_tiny", "--device", "cpu", "--port", "0",
        "--logdir", str(logdir), "--history-interval", "0.1",
        "--slo-rules", str(REPO / "examples" / "slo_rules.json"),
        "--slo-interval", "0.1", "--alert-rules", str(rules),
        "--alert-interval", "0.1", "--alert-webhook",
        f"http://127.0.0.1:{receiver.server_address[1]}/hook"], capsys)
    try:
        for tenant in ("acme", "globex"):
            out = _post(served.port, {"prompt": [1, 2, 3],
                                      "max_new_tokens": 4,
                                      "tenant": tenant})
            assert len(out["tokens"]) == 4
        deadline = time.time() + 10
        while not hook.rows and time.time() < deadline:
            time.sleep(0.05)
        answers = {}
        for path in ("/histz", "/sloz", "/alertz", "/usagez"):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{served.port}{path}", timeout=30) as r:
                answers[path] = r.status
        assert answers == dict.fromkeys(answers, 200)
    finally:
        assert served.close() == 0
        receiver.shutdown()
        receiver.server_close()
    assert hook.rows and hook.rows[0]["rule"] == "ttft_high"
    assert hook.rows[0]["phase"] == "fired"
    history = (logdir / "history.jsonl").read_text()
    for tenant in ("acme", "globex"):
        assert f"serve_tenant_tokens_total.tenant_{tenant}" in history
    assert check_metrics_schema.main(
        [str(logdir / "history.jsonl"), str(logdir / "alerts.jsonl")]) == 0
