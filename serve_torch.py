#!/usr/bin/env python3
"""serve_torch.py - the serving entry point of the PyTorch port.

The twin of ``serve.py``: builds a GPT config (from a checkpoint that
``train_torch.py`` wrote, or seeded random weights), the port's paged-KV
``Engine`` on it, and the ``/generatez`` HTTP front beside the status
family (``/healthz``, ``/statusz``, ``/varz``, ``/threadz``, ``/memz``)
and the per-tenant usage ledger (``GET /usagez``).  Runs on the CUDA
card unless ``--device cpu`` is given::

    python serve_torch.py --config gpt_small --port 8600
    python serve_torch.py --config gpt_small --checkpoint ckpts/
    python serve_torch.py --config gpt_tiny --device cpu --port 0 \\
        --prefix-cache --fused-sampling --speculate 4 --logdir /tmp/s
    curl -s -X POST 127.0.0.1:<port>/generatez \\
        -d '{"prompt": [1, 2, 3], "max_new_tokens": 8}'

The flags are ``serve.py``'s, with its names and defaults, plus
``--device`` and ``--dtype`` as ``train_torch.py`` has them.  The
operations planes run beside the engine as in ``serve.py``: the metrics
history store (on by default, ``--history-interval``/``--history-points``:
``GET /histz``, ``history.jsonl``, each tenant's usage series pinned),
the SLO monitor (``--slo-rules``: ``GET /sloz``) and the alert manager
(``--alert-rules``: ``GET /alertz``, ``alerts.jsonl``, incident bundles,
``--alert-webhook``, and ``/healthz?deep=1`` composed from the alerts,
the engine and the SLOs).

On startup one JSON line goes to stdout, ``{"serving": true, "port": N,
...}``, so a launcher can find an ephemeral port.  SIGINT and SIGTERM
start a bounded drain: new requests get 503, in-flight ones finish, and
after ``--drain-timeout`` seconds the process exits 1 with what is still
running; a clean drain exits 0.  ``main(argv, stop=event)`` serves until
the event is set, for a caller that runs it on a thread.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import signal
import sys
import threading
import time

import torch

from distributedtensorflow_tpu_torch import models
from distributedtensorflow_tpu_torch import obs
from distributedtensorflow_tpu_torch.device import resolve_device
from distributedtensorflow_tpu_torch.serve import Engine, ServeServer

logger = logging.getLogger("serve_torch")

#: --config choice -> (GPTConfig factory, the matching train_torch.py
#: workload and whether it is its test size).
CONFIGS = {
    "gpt_tiny": ("gpt_tiny", ("gpt_lm", True)),
    "gpt_small": ("gpt_small", ("gpt_lm", False)),
    "gpt_medium": ("gpt_medium", ("gpt_medium_lm", False)),
}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", choices=sorted(CONFIGS), default="gpt_small")
    p.add_argument("--checkpoint", default=None,
                   help="train_torch.py checkpoint dir to serve (default: "
                        "seeded random weights)")
    p.add_argument("--port", type=int, default=8600,
                   help="HTTP port (0 = ephemeral; printed on stdout)")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (loopback default; the endpoints "
                        "have no auth)")
    p.add_argument("--max-slots", type=int, default=4,
                   help="concurrent decode slots")
    p.add_argument("--max-queue", type=int, default=64,
                   help="bounded request queue; beyond it POSTs get 429")
    p.add_argument("--block-size", type=int, default=16,
                   help="paged-KV block size in tokens")
    p.add_argument("--kv-blocks", type=int, default=None,
                   help="total KV pool blocks (default: max-slots * "
                        "max-context/block-size = no oversubscription)")
    p.add_argument("--prefill-chunk", type=int, default=16,
                   help="prefill program width in tokens")
    p.add_argument("--prefill-budget", type=int, default=0,
                   help="max prefill tokens per scheduler iteration, "
                        "round-robin across unfilled requests, before one "
                        "decode step for the running slots (0 = "
                        "unbudgeted)")
    p.add_argument("--prefix-cache", action="store_true",
                   help="copy-on-write prefix caching: full KV blocks of "
                        "completed prompts are indexed by content hash and "
                        "mapped refcount+1 into later requests sharing the "
                        "prefix; refcount-0 blocks stay warm and are "
                        "LRU-evicted only under pool pressure")
    p.add_argument("--fused-sampling", action="store_true",
                   help="decode fast path: sampling in the decode program "
                        "on the device (per-slot seeds and last tokens "
                        "stay there); the host reads one small (tokens, "
                        "counts) array an iteration")
    p.add_argument("--speculate", type=int, default=0, metavar="K",
                   help="self-speculative decoding (implies "
                        "--fused-sampling): an n-gram drafter proposes up "
                        "to K tokens from the request's own history, "
                        "verified in one multi-token pass; greedy output "
                        "is the sequential path's (0 = off)")
    p.add_argument("--spec-ngram", type=int, default=3,
                   help="longest suffix n-gram the drafter matches")
    p.add_argument("--max-context", type=int, default=None,
                   help="serving context cap (default: model max_seq)")
    p.add_argument("--max-new-cap", type=int, default=None,
                   help="reject requests asking for more new tokens")
    p.add_argument("--logdir", default=None,
                   help="writes requests.jsonl / metrics.jsonl / "
                        "steps.jsonl / usage.jsonl / metrics.prom / "
                        "trace.jsonl / flight.jsonl here")
    p.add_argument("--drain-timeout", type=float, default=30.0,
                   help="bounded SIGTERM drain: refuse new submits with 503, "
                        "finish in-flight requests, force exit 1 after this "
                        "many seconds")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--step-ring", type=int, default=512,
                   help="engine step-log ring size (GET /stepz, "
                        "<logdir>/steps.jsonl)")
    p.add_argument("--history-interval", type=float, default=2.0,
                   help="embedded metrics history store (obs.tsdb): "
                        "sample the registry (and SLO good/total "
                        "snapshots) every this many seconds into fixed-"
                        "memory downsampling rings, served at GET /histz "
                        "and appended to <logdir>/history.jsonl (offline "
                        "SLO burn recomputation); 0 = off")
    p.add_argument("--history-points", type=int, default=360,
                   help="history ring size per series: on overflow the "
                        "ring decimates 2:1 and doubles its resolution, "
                        "so memory stays fixed for any run length")
    p.add_argument("--slo-rules", default=None, metavar="JSON",
                   help="SLO rule file (obs.slo schema): evaluate burn "
                        "rates over the serve_* histograms on a "
                        "background thread, expose slo_burn_rate{slo=,"
                        "window=} in /varz and GET /sloz, raise "
                        "slo_violation flight events on threshold trips")
    p.add_argument("--alert-rules", default=None, metavar="JSON",
                   help="alert rule file (obs.alerts schema): evaluate "
                        "threshold/burn/absence/anomaly rules over the "
                        "registry / history store / SLO monitor on a "
                        "background thread; firings append "
                        "<logdir>/alerts.jsonl, write incident evidence "
                        "bundles under <logdir>/incidents/, and serve "
                        "GET /alertz + /healthz?deep=1")
    p.add_argument("--alert-interval", type=float, default=5.0,
                   help="seconds between alert rule evaluations")
    p.add_argument("--alert-webhook", default=None, metavar="URL",
                   help="POST every alert transition to this http:// URL "
                        "as JSON (through net.rpc: deadline, retries, "
                        "circuit breaker)")
    p.add_argument("--slo-interval", type=float, default=5.0,
                   help="seconds between SLO burn-rate evaluations")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default=None,
                   help="compute dtype in place of the config's")
    return p.parse_args(argv)


def build_model(args, cfg, device) -> models.GPTLM:
    """The model to serve: with ``--checkpoint``, the newest verified
    checkpoint that ``train_torch.py`` wrote for the config's workload,
    restored through ``CheckpointManager.restore_latest`` into the state
    ``train_torch`` builds; else seeded random weights."""
    model = models.GPTLM(cfg, device=device)
    if not args.checkpoint:
        logger.info("random weights (no --checkpoint), seed %d", args.seed)
        model.load_state_dict(models.init_params(
            cfg, torch.Generator().manual_seed(args.seed)))
        return model
    from distributedtensorflow_tpu_torch.checkpoint import CheckpointManager
    from distributedtensorflow_tpu_torch.train import TrainState
    from distributedtensorflow_tpu_torch.workloads import get_workload

    workload, test_size = CONFIGS[args.config][1]
    wl = get_workload(workload, test_size=test_size)
    trained = wl.model_cls(wl.cfg, device=device)
    trained.load_state_dict(wl.init_params(
        wl.cfg, torch.Generator().manual_seed(args.seed)))
    state = TrainState.create(trained, wl.make_optimizer)
    if CheckpointManager(args.checkpoint).restore_latest(state) is None:
        raise SystemExit(
            f"--checkpoint {args.checkpoint}: no usable checkpoint found")
    logger.info("restored checkpoint step %d from %s", state.step,
                args.checkpoint)
    model.load_state_dict(state.model.state_dict())
    return model


def _drain(server, engine, timeout_s: float) -> bool:
    """Refuse new submits and wait up to ``timeout_s`` for the queue and
    the slots to empty; True when they did."""
    server.begin_drain()
    deadline = time.monotonic() + max(timeout_s, 0.0)
    while time.monotonic() < deadline:
        st = engine.state()
        if st["queue_depth"] == 0 and st["active_slots"] == 0:
            return True
        time.sleep(0.1)
    return False


def _load_rules(args) -> tuple[list | None, list | None]:
    """The ``--slo-rules`` and ``--alert-rules`` files (None without the
    flag), parsed and checked before anything starts (``serve.py``'s
    usage errors)."""
    slo_rules = alert_rules = None
    if args.slo_rules:
        try:
            slo_rules = obs.slo.load_rules(args.slo_rules)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            raise SystemExit(f"--slo-rules {args.slo_rules}: {e}")
    if args.alert_rules:
        try:
            alert_rules = obs.alerts.load_rules(args.alert_rules)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            raise SystemExit(f"--alert-rules {args.alert_rules}: {e}")
    return slo_rules, alert_rules


def _start_planes(args, engine, server, slo_rules, alert_rules):
    """``(slo_monitor, history, alert_manager)``, each None unless its
    flags ask for it, started and served on the frontend's status server
    as ``serve.py:270-340`` starts them."""
    slo_monitor = history = alert_manager = None
    status = server.status_server
    if slo_rules is not None:
        slo_monitor = obs.SLOMonitor(
            slo_rules, interval_s=args.slo_interval).install(status).start()
        logger.info("slo monitor: %d rule(s) from %s (GET /sloz)",
                    len(slo_rules), args.slo_rules)
    if args.history_interval > 0:
        # the registry (and, with --slo-rules, each rule's good/total
        # snapshot, so burn rates are recomputable offline from
        # history.jsonl) next to the SLO monitor
        history = obs.MetricsHistory(
            interval_s=args.history_interval,
            points_per_series=args.history_points, logdir=args.logdir,
            rules=slo_monitor.rules if slo_monitor is not None else None,
        ).install(status).start()
        # each tenant's usage series pinned: tenant cardinality cannot
        # crowd them out of the rings
        engine.usage.attach_history(history)
        logger.info("metrics history: sampling every %.1fs (GET /histz)",
                    args.history_interval)
    if alert_rules is not None:
        sinks = [obs.alerts.log_sink]
        if args.alert_webhook:
            sinks.append(obs.alerts.make_webhook_sink(args.alert_webhook))
        alert_manager = obs.AlertManager(
            alert_rules, interval_s=args.alert_interval, logdir=args.logdir,
            history=history, slo_monitor=slo_monitor, sinks=sinks,
            step_records_fn=engine.step_records)
        alert_manager.install(status)
        components = {
            "alerts": alert_manager.health_component,
            "engine": obs.alerts.engine_health_component(engine, server),
        }
        if slo_monitor is not None:
            components["slo"] = obs.alerts.slo_health_component(slo_monitor)
        status.deep_health_fn = obs.alerts.compose_deep_health(components)
        alert_manager.start()
        logger.info(
            "alerts: %d rule(s) from %s evaluated every %.1fs%s (GET "
            "/alertz)", len(alert_rules), args.alert_rules,
            args.alert_interval,
            f" (webhook {args.alert_webhook})" if args.alert_webhook else "")
    return slo_monitor, history, alert_manager


def main(argv=None, stop: threading.Event | None = None) -> int:
    """Serve until SIGINT/SIGTERM (or ``stop`` is set), then drain;
    returns 0 after a clean drain, 1 after a forced one."""
    args = parse_args(argv)
    slo_rules, alert_rules = _load_rules(args)
    device = resolve_device(args.device)
    cfg = getattr(models, CONFIGS[args.config][0])()
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=getattr(torch, args.dtype))
    model = build_model(args, cfg, device)
    tracer = flight = None
    if args.logdir:
        # queue/prefill/decode spans of every completed request, and the
        # flight ring for the drain's forensics
        tracer = obs.TraceRecorder(
            os.path.join(args.logdir, "trace.jsonl")).install()
        flight = obs.FlightRecorder(
            path=os.path.join(args.logdir, "flight.jsonl"))
        obs.install_recorder(flight)
        flight.install_crash_hooks()
    engine = Engine(
        model, max_slots=args.max_slots, max_queue=args.max_queue,
        block_size=args.block_size, num_blocks=args.kv_blocks,
        prefill_chunk=args.prefill_chunk,
        prefill_budget=args.prefill_budget or None,
        prefix_cache=args.prefix_cache,
        fused_sampling=args.fused_sampling or args.speculate > 0,
        speculate=args.speculate, spec_ngram=args.spec_ngram,
        max_context=args.max_context, max_new_cap=args.max_new_cap,
        logdir=args.logdir, log_every=args.log_every,
        step_ring=args.step_ring,
    ).start()
    server = ServeServer(engine, args.port, host=args.host).start()
    engine.usage.install(server.status_server)
    slo_monitor, history, alert_manager = _start_planes(
        args, engine, server, slo_rules, alert_rules)
    if stop is None:
        stop = threading.Event()

        def _on_signal(signum, frame):
            logger.info("signal %d: draining and shutting down", signum)
            stop.set()

        signal.signal(signal.SIGINT, _on_signal)
        signal.signal(signal.SIGTERM, _on_signal)
    print(json.dumps({
        "serving": True, "port": server.port, "config": args.config,
        "max_slots": args.max_slots, "logdir": args.logdir,
        "device": str(device),
    }), flush=True)
    logger.info(
        "serving %s on %s:%d (%s, slots=%d queue=%d block=%d "
        "prefix_cache=%s prefill_budget=%s fused_sampling=%s speculate=%d)",
        args.config, args.host, server.port, device, args.max_slots,
        args.max_queue, args.block_size, args.prefix_cache,
        args.prefill_budget or "unbudgeted",
        args.fused_sampling or args.speculate > 0, args.speculate)
    drained = False
    try:
        while not stop.wait(0.2):
            pass
        if alert_manager is not None:
            # before the SLO monitor: stop() runs one final evaluation (so
            # resolve rows land) and burn rules read the monitor's state
            alert_manager.stop()
        if slo_monitor is not None:
            slo_monitor.stop()
        drained = _drain(server, engine, args.drain_timeout)
        if not drained:
            st = engine.state()
            logger.error(
                "drain timeout (%.1fs): %d queued + %d active request(s) "
                "still running; forcing exit", args.drain_timeout,
                st["queue_depth"], st["active_slots"])
            obs.record_event(
                "exception", reason="drain_timeout",
                drain_timeout_s=args.drain_timeout,
                queued=st["queue_depth"], active=st["active_slots"])
            if flight is not None:
                flight.dump(reason="drain_timeout")
    finally:
        if alert_manager is not None:
            alert_manager.stop()
        if slo_monitor is not None:
            slo_monitor.stop()
        server.stop()
        engine.stop(drain=drained)
        if history is not None:
            # after the engine's drain: the final tick snapshots the
            # completed run's counters into history.jsonl
            history.stop()
        if tracer is not None:
            tracer.uninstall()
            tracer.close()
        if flight is not None:
            flight.record("serve_shutdown", drained=drained,
                          forced=not drained)
            flight.dump(reason="shutdown")
            flight.uninstall_crash_hooks()
            obs.install_recorder(None)
    st = engine.state()
    logger.info(
        "served %d ok / %d rejected / %d error; %d tokens, peak occupancy "
        "%d%s", st["counters"]["ok"], st["counters"]["rejected"],
        st["counters"]["error"], st["counters"]["tokens_generated"],
        st["occupancy_max"], "" if drained else " (FORCED exit at drain "
        "bound)")
    return 0 if drained else 1


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    sys.exit(main(sys.argv[1:]))
