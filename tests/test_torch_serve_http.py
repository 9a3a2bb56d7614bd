"""The port's ``/generatez`` front (``serve.server.ServeServer``) over a
port ``Engine``, in-process on the CPU, bound to port 0.

``POST /generatez`` returns the engine's own tokens, blocking and as a
chunked stream; ``GET /generatez``, ``/stepz``, ``/usagez`` and
``/healthz`` answer; the error codes are JAX's (400 for a malformed
request, 429 for a full queue, 503 while draining or once the engine is
stopped, 504 past the timeout); ``/healthz`` answers 503 once the
engine's loop has died.
"""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch.obs.registry import Registry
from distributedtensorflow_tpu_torch.serve import Engine, ServeServer

_KW = dict(max_slots=2, max_queue=8, block_size=4, prefill_chunk=4,
           max_context=64)


def _post(port, payload, timeout=60, raw=False):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generatez",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        r = urllib.request.urlopen(req, timeout=timeout)
        body = r.read().decode()
        return r.status, body if raw else json.loads(body)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _get(port, path, timeout=10):
    try:
        r = urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                   timeout=timeout)
        return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(tm.gpt_tiny(), dtype=torch.float32, max_seq=64)
    m = tm.GPTLM(cfg, device="cpu")
    m.load_state_dict(tm.init_params(cfg, torch.Generator().manual_seed(0)))
    return m


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(0, 512, n)] for n in (7, 12)]


@pytest.fixture()
def frontend(model):
    engine = Engine(model, registry=Registry(), fused_sampling=True,
                    speculate=2, **_KW).start()
    server = ServeServer(engine, 0, registry=Registry()).start()
    engine.usage.install(server.status_server)
    yield server, engine
    server.stop()
    engine.stop()


def _engine_tokens(model, prompt, n):
    eng = Engine(model, registry=Registry(), **_KW)
    req = eng.submit(prompt, max_new_tokens=n)
    while not req._done.is_set():
        eng.step()
    return req.tokens


def test_post_blocking_and_streamed_return_the_engine_tokens(
        frontend, model, prompts):
    server, _ = frontend
    want = _engine_tokens(model, prompts[0], 6)
    status, body = _post(server.port, {"prompt": prompts[0],
                                       "max_new_tokens": 6,
                                       "tenant": "alpha"})
    assert status == 200 and body["tokens"] == want
    assert body["finish_reason"] == "length" and body["tenant"] == "alpha"
    assert 0 <= body["ttft_s"] <= body["e2e_s"]
    status, raw = _post(server.port, {"prompt": prompts[0],
                                      "max_new_tokens": 6, "stream": True},
                        raw=True)
    lines = [json.loads(line) for line in raw.splitlines()]
    assert status == 200 and lines[-1]["done"] and \
        lines[-1]["status"] == "ok"
    assert [t for line in lines[:-1] for t in line["tokens"]] == want


def test_get_endpoints_answer(frontend, prompts):
    server, engine = frontend
    threads = [threading.Thread(target=_post, args=(
        server.port, {"prompt": p, "max_new_tokens": 5, "seed": i,
                      "temperature": 0.7, "top_k": 20}))
        for i, p in enumerate(prompts * 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    status, raw = _get(server.port, "/generatez")
    st = json.loads(raw)
    assert status == 200 and st["counters"]["ok"] == 4
    assert st["kv"]["blocks_free"] == st["kv"]["blocks_total"]
    assert st["speculate"] == 2
    status, raw = _get(server.port, "/stepz?n=3")
    stepz = json.loads(raw)
    assert status == 200 and stepz["n"] == 3
    assert stepz["steps_total"] == engine.steps_total
    assert _get(server.port, "/stepz?n=0")[0] == 400
    status, raw = _get(server.port, "/usagez?json")
    assert status == 200 and json.loads(raw)["tenants"]["default"][
        "requests_ok"] == 4
    status, text = _get(server.port, "/usagez")
    assert status == 200 and "per-tenant usage ledger" in text
    assert _get(server.port, "/usagez?tenant=nobody")[0] == 404
    status, raw = _get(server.port, "/healthz")
    assert status == 200 and json.loads(raw)["ok"] is True
    status, prom = _get(server.port, "/varz")
    assert status == 200


@pytest.mark.parametrize("payload", [
    {"max_new_tokens": 4},
    {"prompt": "hi", "max_new_tokens": 4},
    {"prompt": [], "max_new_tokens": 4},
    {"prompt": [1, 2]},
    {"prompt": [1, 2], "max_new_tokens": 0},
    {"prompt": [10 ** 9], "max_new_tokens": 4},
    {"prompt": [1, 2], "max_new_tokens": 4.9},
    {"prompt": [1, 2], "max_new_tokens": 4, "top_k": True},
    {"prompt": [1, 2], "max_new_tokens": 4, "tenant": "no spaces"},
    {"prompt": [1, 2], "max_new_tokens": 4, "trace_id": ""},
    {"prompt": [1, 2], "max_new_tokens": 4, "stream": "yes"},
    {"prompt": [1, 2], "max_new_tokens": 4, "timeout_s": -1},
])
def test_malformed_requests_are_400(frontend, payload):
    server, _ = frontend
    status, body = _post(server.port, payload)
    assert status == 400 and "error" in body


def test_queue_full_429_timeout_504_stopped_503(model):
    """An engine that is not running: the queue fills (429), a request
    past its timeout is 504, and a stopped engine is 503."""
    engine = Engine(model, registry=Registry(),
                    **{**_KW, "max_queue": 1})
    server = ServeServer(engine, 0, registry=Registry()).start()
    try:
        engine.submit([1, 2, 3], max_new_tokens=2)
        status, body = _post(server.port, {"prompt": [1, 2],
                                           "max_new_tokens": 2})
        assert status == 429 and "queue full" in body["error"]
        engine._queue.clear()
        status, body = _post(server.port, {"prompt": [1, 2],
                                           "max_new_tokens": 2,
                                           "timeout_s": 0.05})
        assert status == 504 and "timeout" in body["error"]
        engine.stop()
        status, body = _post(server.port, {"prompt": [1, 2],
                                           "max_new_tokens": 2})
        assert status == 503 and "stopped" in body["error"]
    finally:
        server.stop()


def test_draining_is_503(frontend):
    server, _ = frontend
    server.begin_drain()
    status, body = _post(server.port, {"prompt": [1, 2],
                                       "max_new_tokens": 2})
    assert status == 503 and "draining" in body["error"]
    assert server.draining


def test_healthz_503_after_the_loop_dies(model, monkeypatch):
    monkeypatch.setattr(threading, "excepthook", lambda args: None)
    engine = Engine(model, registry=Registry(), **_KW)

    def boom():
        raise RuntimeError("device lost (simulated)")

    engine._run_decode_step = boom  # the first decode step raises
    engine.start()
    server = ServeServer(engine, 0, registry=Registry()).start()
    try:
        assert _get(server.port, "/healthz")[0] == 200
        status, body = _post(server.port, {"prompt": [1, 2],
                                           "max_new_tokens": 2})
        assert status == 500 and "device lost" in body["error"]
        status, raw = _get(server.port, "/healthz")
        assert status == 503 and json.loads(raw)["ok"] is False
        assert not engine.healthy
        status, body = _post(server.port, {"prompt": [1, 2],
                                           "max_new_tokens": 2})
        assert status == 503 and "loop dead" in body["error"]
    finally:
        server.stop()
        engine.stop()
