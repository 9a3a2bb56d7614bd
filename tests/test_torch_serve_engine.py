"""The port's ``Engine`` at every ``serve.py`` setting, against JAX's.

One request mix, eight greedy requests on three slots (so later ones
take freed slots): five share a 24-token header aligned to blocks of 8,
two prompts are periodic (the n-gram drafter fires on them), one is
random.  Both engines are driven synchronously through ``step()``, so
admission order, chunking and block ids are deterministic on both sides,
from the same converted fp32 ``gpt_tiny`` weights.  In each mode
(defaults, ``prefix_cache``, ``prefill_budget=8``, ``num_blocks`` at half
of full provisioning, ``fused_sampling``, ``fused_sampling`` with
``speculate=4``) the port's tokens equal the JAX engine's token for
token, and every block is allocatable again at the end.  The prefix
hits and per-request cached tokens equal JAX's; speculation's tokens
equal the sequential path's with ``accepted <= drafted``; streamed
events concatenate to the final tokens; ``state()`` has JAX's keys; the
logdir's streams pass ``tools/check_metrics_schema.py`` and
``tools/run_report.py``.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtensorflow_tpu.models import GPTLM as JaxGPTLM
from distributedtensorflow_tpu.models import gpt_tiny as jax_gpt_tiny
from distributedtensorflow_tpu.obs.registry import Registry as JaxRegistry
from distributedtensorflow_tpu.serve import Engine as JaxEngine
from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch.obs.registry import Registry
from distributedtensorflow_tpu_torch.serve import Engine
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401

_BASE = dict(max_slots=3, max_queue=16, block_size=8, prefill_chunk=8,
             max_context=64)
_FULL_BLOCKS = 3 * 64 // 8
MODES = {
    "defaults": {},
    "prefix_cache": {"prefix_cache": True},
    "prefill_budget": {"prefill_budget": 8},
    "half_pool": {"num_blocks": _FULL_BLOCKS // 2},
    "fused": {"fused_sampling": True},
    "speculate": {"fused_sampling": True, "speculate": 4},
}
NEW_TOKENS = 10


def _mix():
    rng = np.random.default_rng(0)
    header = [int(t) for t in rng.integers(0, 512, 24)]
    tails = [[int(t) for t in rng.integers(0, 512, n)]
             for n in (3, 9, 16, 1, 12)]
    shared = [header + tail for tail in tails]
    periodic = [([5, 9, 2, 7] * 8)[:26], ([11, 3, 8] * 8)[:13]]
    other = [int(t) for t in rng.integers(0, 512, 30)]
    # header requests at 0, 3, 4, 6, 7: some are admitted after the first
    # has registered its blocks
    return [shared[0], periodic[0], other, shared[1], shared[2],
            periodic[1], shared[3], shared[4]]


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jax_gpt_tiny(), dtype=jnp.float32, max_seq=64)
    tcfg = dataclasses.replace(tm.gpt_tiny(), dtype=torch.float32,
                               max_seq=64)
    params = jax.jit(JaxGPTLM(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    model = tm.GPTLM(tcfg, device="cpu")
    model.load_state_dict(tm.params_from_flax(params, tcfg))
    return jcfg, params, model


def _drain(engine, reqs, max_steps=400):
    for _ in range(max_steps):
        if all(r._done.is_set() for r in reqs):
            return
        engine.step()
    raise AssertionError("engine did not finish within max_steps")


def _serve(engine, prompts, **submit):
    reqs = [engine.submit(p, max_new_tokens=NEW_TOKENS, **submit)
            for p in prompts]
    _drain(engine, reqs)
    return reqs


@pytest.fixture(scope="module")
def runs(weights):
    """mode -> (port engine, port requests, JAX engine, JAX requests),
    each mode run once for the module."""
    jcfg, params, model = weights
    cache = {}

    def run(mode):
        if mode not in cache:
            kw = {**_BASE, **MODES[mode]}
            eng = Engine(model, registry=Registry(), **kw)
            jeng = JaxEngine(params, jcfg, registry=JaxRegistry(), **kw)
            cache[mode] = (eng, _serve(eng, _mix()), jeng,
                           _serve(jeng, _mix()))
        return cache[mode]

    return run


@pytest.mark.parametrize("mode", list(MODES))
def test_tokens_equal_jax_engine(runs, mode):
    eng, reqs, jeng, jreqs = runs(mode)
    for r, jr in zip(reqs, jreqs):
        assert r.status == jr.status == "ok", (r.error, jr.error)
        assert len(r.tokens) == NEW_TOKENS
        assert r.tokens == jr.tokens, (mode, r.id)
        assert r.cached_prefix_tokens == jr.cached_prefix_tokens
        assert r.cached_prefix_tokens + r.prefill_tokens == len(r.prompt)
    assert eng.decode_steps == jeng.decode_steps
    assert eng.counters == jeng.counters
    alloc = eng.kv.allocator
    assert alloc.used_blocks == 0 and all(s is None for s in eng._slots)
    assert alloc.allocatable_blocks == alloc.num_blocks


def test_every_mode_gives_the_default_tokens(runs):
    """Greedy output does not depend on the mode: the prefix cache, the
    budget, the half pool, fused sampling and speculation all give the
    sequential default path's tokens."""
    base = [r.tokens for r in runs("defaults")[1]]
    for mode in MODES:
        assert [r.tokens for r in runs(mode)[1]] == base, mode


def test_prefix_hits_equal_jax(runs):
    eng, reqs, jeng, _ = runs("prefix_cache")
    stats, jstats = eng.kv.stats(), jeng.kv.stats()
    assert stats["prefix_hits"] == jstats["prefix_hits"] > 0
    assert stats == jstats
    assert sum(r.cached_prefix_tokens for r in reqs) \
        == stats["prefix_cached_tokens"] > 0
    assert eng.counters["prefill_tokens"] \
        == sum(len(r.prompt) for r in reqs) - stats["prefix_cached_tokens"]


def test_pressure_and_budget_schedules_equal_jax(runs):
    """The half pool makes admission wait for blocks and the budget
    splits prefill across iterations; both schedules equal JAX's."""
    for mode, key in (("half_pool", "occupancy_max"),
                      ("prefill_budget", "prefill_budget_stalls")):
        eng, _, jeng, _ = runs(mode)
        st, jst = eng.state(), jeng.state()
        assert st[key] == jst[key]
        assert st["prefill_iters"] == jst["prefill_iters"]
        assert st["steps_total"] == jst["steps_total"]
    assert runs("prefill_budget")[0].prefill_budget_stalls > 0
    assert runs("half_pool")[0].occupancy_max \
        < runs("defaults")[0].occupancy_max


def test_speculation_counts(runs):
    eng, reqs, jeng, _ = runs("speculate")
    c = eng.counters
    assert 0 <= c["spec_accepted"] <= c["spec_drafted"]
    assert c["spec_drafted"] > 0
    assert c["spec_drafted"] == jeng.counters["spec_drafted"]
    assert all(0 <= r.accepted <= r.drafted for r in reqs)
    assert eng.state()["tokens_per_step"] >= 1.0
    assert c["host_sample_rounds"] == 0
    assert c["decode_dispatches"] == eng.decode_steps


def test_state_has_jax_keys(runs):
    eng, _, jeng, _ = runs("speculate")
    st, jst = eng.state(), jeng.state()
    assert st.keys() == jst.keys()
    assert st["kv"].keys() == jst["kv"].keys()
    assert st["counters"].keys() == jst["counters"].keys()
    assert json.dumps(st)


def test_streamed_events_concatenate_to_tokens(weights):
    _, _, model = weights
    for kw in ({}, {"fused_sampling": True, "speculate": 4}):
        eng = Engine(model, registry=Registry(), **_BASE, **kw)
        reqs = _serve(eng, _mix()[:4], stream=True)
        for r in reqs:
            got = []
            while True:
                kind, payload = r._events.get(timeout=5)
                if kind == "done":
                    break
                got.extend(payload)
            assert got == r.tokens


def test_seeded_fused_sampling_repeats(weights):
    """A seeded request through the fused sampler repeats its tokens on a
    second engine; another seed differs; every token is in range."""
    _, _, model = weights
    prompt = _mix()[2]

    def run(seed):
        eng = Engine(model, registry=Registry(), fused_sampling=True,
                     speculate=4, **_BASE)
        (r,) = _serve(eng, [prompt], temperature=0.9, top_k=40, seed=seed)
        return r.tokens

    a = run(3)
    assert a == run(3) and a != run(4)
    assert all(0 <= t < 512 for t in a)


def test_logdir_streams_pass_schema_and_run_report(weights, tmp_path):
    from tools import check_metrics_schema, run_report

    _, _, model = weights
    logdir = str(tmp_path / "serve")
    eng = Engine(model, registry=Registry(), logdir=logdir, log_every=1,
                 prefix_cache=True, fused_sampling=True, speculate=4,
                 **_BASE)
    tenants = ["alpha", "beta"]
    reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS, tenant=tenants[i % 2])
            for i, p in enumerate(_mix())]
    _drain(eng, reqs)
    eng.stop()
    for name in ("requests.jsonl", "metrics.jsonl", "steps.jsonl",
                 "usage.jsonl", "metrics.prom"):
        assert os.path.getsize(os.path.join(logdir, name)) > 0, name
    errs, _ = check_metrics_schema.check_requests_file(
        os.path.join(logdir, "requests.jsonl"))
    assert errs == [], errs
    errs, _ = check_metrics_schema.check_file(
        os.path.join(logdir, "metrics.jsonl"))
    assert errs == [], errs
    assert check_metrics_schema.main([
        os.path.join(logdir, n) for n in (
            "requests.jsonl", "metrics.jsonl", "steps.jsonl", "usage.jsonl",
            "metrics.prom")]) == 0
    rows = [json.loads(line)
            for line in open(os.path.join(logdir, "requests.jsonl"))]
    for row in rows:
        assert row["status"] == "ok"
        assert row["cached_prefix_tokens"] + row["prefill_tokens"] \
            == row["prompt_tokens"]
        attr = sum(row[k] for k in row if k.startswith("attr_"))
        assert attr == pytest.approx(row["e2e_s"], abs=1e-4)
    assert run_report.main([logdir]) == 0
    report = run_report.build_report(logdir)
    assert report["serving"]["decode_fast_path"]["speculate"] == 4
