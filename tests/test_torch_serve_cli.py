"""``serve_torch.py``, the port's serving entry point, on the CPU.

``serve_torch.main`` runs on a thread with a stop event in place of a
signal: it prints the startup line, serves requests over HTTP on an
ephemeral port and drains to exit 0.  With ``--checkpoint`` it restores
the checkpoint that ``train_torch.main`` wrote for ``gpt_lm`` at test
size, and its greedy tokens equal an engine's built in memory on the
restored state's model.  Its flags are ``serve.py``'s, with the same
names and defaults, plus ``--device`` and ``--dtype``.
"""

import argparse
import dataclasses
import json
import threading
import time
import urllib.request

import pytest
import torch

import serve
import serve_torch
import train_torch
from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch.checkpoint import CheckpointManager
from distributedtensorflow_tpu_torch.obs.registry import Registry
from distributedtensorflow_tpu_torch.serve import Engine
from distributedtensorflow_tpu_torch.train import TrainState
from distributedtensorflow_tpu_torch.workloads import get_workload

PROMPT = [5, 9, 2, 7, 5, 9, 2, 7, 5, 9, 2]


def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generatez",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read().decode())


class _Served:
    """``serve_torch.main(argv, stop=...)`` on a thread; the startup line
    read from the captured stdout."""

    def __init__(self, argv, capsys):
        self.stop = threading.Event()
        self.rc = None
        self.thread = threading.Thread(target=self._run, args=(argv,))
        self.thread.start()
        out = ""
        deadline = time.time() + 120
        while "serving" not in out:
            assert time.time() < deadline and self.thread.is_alive(), out
            time.sleep(0.05)
            out += capsys.readouterr().out
        self.startup = json.loads(out.strip().splitlines()[0])
        self.port = self.startup["port"]

    def _run(self, argv):
        self.rc = serve_torch.main(argv, stop=self.stop)

    def close(self):
        self.stop.set()
        self.thread.join(timeout=60)
        return self.rc


def test_main_serves_and_drains(capsys, tmp_path):
    logdir = tmp_path / "serve"
    served = _Served(["--config", "gpt_tiny", "--device", "cpu", "--port",
                      "0", "--prefix-cache", "--fused-sampling",
                      "--speculate", "4", "--block-size", "8",
                      "--prefill-chunk", "8", "--logdir", str(logdir)],
                     capsys)
    try:
        assert served.startup["serving"] is True
        assert served.startup["config"] == "gpt_tiny"
        assert served.startup["device"] == "cpu"
        body = _post(served.port, {"prompt": PROMPT * 2,
                                   "max_new_tokens": 6})
        again = _post(served.port, {"prompt": PROMPT * 2,
                                    "max_new_tokens": 6})
        with urllib.request.urlopen(
                f"http://127.0.0.1:{served.port}/generatez") as r:
            state = json.loads(r.read().decode())
    finally:
        rc = served.close()
    assert rc == 0
    assert body["new_tokens"] == 6 and again["tokens"] == body["tokens"]
    assert state["prefix_cache"] and state["speculate"] == 4
    assert state["kv"]["prefix_hits"] == 1
    rows = [json.loads(line) for line in open(logdir / "requests.jsonl")]
    assert [r["status"] for r in rows] == ["ok", "ok"]
    for name in ("metrics.prom", "usage.jsonl", "trace.jsonl",
                 "flight.jsonl", "steps.jsonl"):
        assert (logdir / name).stat().st_size > 0, name


def test_checkpoint_serves_the_trained_model(capsys, tmp_path, caplog):
    ckdir = str(tmp_path / "ck")
    train_torch.main(["--workload", "gpt_lm", "--test-size", "--device",
                      "cpu", "--steps", "2", "--log-every", "1",
                      "--checkpoint-dir", ckdir, "--prefetch-depth", "0"])
    capsys.readouterr()
    # the engine built in memory on the restored state's model
    wl = get_workload("gpt_lm", test_size=True)
    trained = wl.model_cls(wl.cfg, device="cpu")
    state = TrainState.create(trained, wl.make_optimizer)
    assert CheckpointManager(ckdir).restore_latest(state) is not None
    assert state.step == 2
    cfg = dataclasses.replace(tm.gpt_tiny(), dtype=torch.float32)
    model = tm.GPTLM(cfg, device="cpu")
    model.load_state_dict(state.model.state_dict())
    eng = Engine(model, registry=Registry())
    req = eng.submit(PROMPT, max_new_tokens=8)
    while not req._done.is_set():
        eng.step()

    caplog.set_level("INFO", logger="serve_torch")
    served = _Served(["--config", "gpt_tiny", "--device", "cpu", "--port",
                      "0", "--dtype", "float32", "--checkpoint", ckdir],
                     capsys)
    try:
        body = _post(served.port, {"prompt": PROMPT, "max_new_tokens": 8})
    finally:
        assert served.close() == 0
    assert body["tokens"] == req.tokens
    assert "restored checkpoint step 2" in caplog.text
    with pytest.raises(SystemExit, match="no usable checkpoint"):
        serve_torch.main(["--config", "gpt_tiny", "--device", "cpu",
                          "--checkpoint", str(tmp_path / "empty")])


def _flags(parser_main):
    """{flag: default} of an argparse entry point, read by intercepting
    its ``parse_args``."""
    seen = {}

    class Stop(Exception):
        pass

    def grab(self, args=None, namespace=None):
        for a in self._actions:
            if a.option_strings and a.dest != "help":
                seen[a.option_strings[0]] = a.default
        raise Stop

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        parser_main([])
    except Stop:
        pass
    finally:
        argparse.ArgumentParser.parse_args = orig
    return seen


def test_flags_are_serve_py_names_and_defaults():
    ours, theirs = _flags(serve_torch.main), _flags(serve.main)
    extra = set(ours) - set(theirs)
    assert extra == {"--device", "--dtype"}
    for flag in set(ours) & set(theirs):
        assert ours[flag] == theirs[flag], flag
    assert ours["--device"] == "cuda"
    assert set(theirs) - set(ours) == set()


def test_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_torch.main(["--config", "gpt_tiny", "--port", "0"])
