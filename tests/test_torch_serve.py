"""The port's serving engine: allocator, paged KV, scheduler, parity.

The allocator and kv-cache checks mirror ``tests/test_serve.py``.  The
load-bearing check is equivalence: for more requests than slots (so a
freed slot takes a queued request), the port's ``Engine`` emits the
same greedy tokens as the JAX ``Engine`` and as the port's own dense
``generate``, from the same converted ``gpt_tiny`` weights in fp32.
This file also holds the port's import rule (no JAX anywhere in the
port or ``chip_smoke.py``) and its device rule.
"""

import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtensorflow_tpu.models import GPTLM as JaxGPTLM
from distributedtensorflow_tpu.models import gpt_tiny as jax_gpt_tiny
from distributedtensorflow_tpu.serve import Engine as JaxEngine
from distributedtensorflow_tpu.serve.sampling import (
    logits_to_probs as jax_logits_to_probs,
)
from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch.device import resolve_device
from distributedtensorflow_tpu_torch.serve import (
    BlockAllocator,
    Engine,
    OutOfBlocksError,
    PagedKVCache,
    QueueFullError,
)
from distributedtensorflow_tpu_torch.serve.model import (
    make_gather_cache_fn,
    make_prefill_fn,
)
from distributedtensorflow_tpu_torch.serve.sampling import logits_to_probs
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]

# ---------------------------------------------------------------- allocator


def test_allocator_all_or_nothing():
    a = BlockAllocator(4)
    got = a.alloc(3)
    assert got is not None and len(got) == 3 and len(set(got)) == 3
    assert a.alloc(2) is None  # only 1 free: no partial grant
    assert a.free_blocks == 1 and a.used_blocks == 3
    a.free(got)
    assert a.free_blocks == 4 and a.used_blocks == 0
    assert a.alloc(4) is not None


def test_allocator_double_free_raises():
    a = BlockAllocator(2)
    got = a.alloc(1)
    a.free(got)
    with pytest.raises(OutOfBlocksError, match="double free|not allocated"):
        a.free(got)
    with pytest.raises(OutOfBlocksError):
        a.free([99])


def test_allocator_exhaustion_and_reuse():
    a = BlockAllocator(3)
    x = a.alloc(3)
    assert a.alloc(1) is None
    a.free(x[:1])
    assert a.alloc(1) == x[:1]  # the freed block is reused


# ------------------------------------------------------------- paged kv cache


def _kv(num_blocks=8, block_size=4, max_context=16, max_slots=2):
    return PagedKVCache(
        num_layers=1, kv_heads=2, head_dim=4, max_slots=max_slots,
        num_blocks=num_blocks, block_size=block_size,
        max_context=max_context, device="cpu",
    )


def test_kv_admit_release_no_leak():
    kv = _kv()
    assert kv.k_pool.shape == (1, 9, 4, 2, 4)  # + the scratch block
    assert kv.admit(0, tokens=6)  # 2 blocks of 4
    assert kv.allocator.used_blocks == 2
    assert (kv.block_tables[0, :2] != kv.scratch_block).all()
    assert (kv.block_tables[0, 2:] == kv.scratch_block).all()
    kv.note_written(0, 5)
    stats = kv.stats()
    assert stats["slots_occupied"] == 1
    assert stats["allocated_tokens"] == 8 and stats["resident_tokens"] == 5
    assert stats["fragmentation"] == pytest.approx(3 / 8)
    kv.release(0)
    assert kv.allocator.used_blocks == 0
    assert (kv.block_tables == kv.scratch_block).all()
    assert kv.stats()["fragmentation"] == 0.0


def test_kv_admit_pressure_and_guards():
    kv = _kv(num_blocks=3, block_size=4, max_context=16)
    assert kv.admit(0, tokens=12)  # 3 blocks: pool drained
    assert not kv.admit(1, tokens=4)  # pressure: all-or-nothing None
    with pytest.raises(OutOfBlocksError, match="occupied"):
        kv.admit(0, tokens=4)
    with pytest.raises(ValueError, match="max_context"):
        kv.release(0) or kv.admit(0, tokens=32)
    kv.admit(0, tokens=4)
    with pytest.raises(OutOfBlocksError, match="capacity"):
        kv.note_written(0, 5)


# ---------------------------------------------------------------- the engine


@pytest.fixture(scope="module")
def served():
    """fp32 gpt_tiny at max_seq 64: JAX params, the JAX config and the
    port model loaded from the same weights."""
    jcfg = dataclasses.replace(jax_gpt_tiny(), dtype=jnp.float32, max_seq=64)
    tcfg = dataclasses.replace(tm.gpt_tiny(), dtype=torch.float32,
                               max_seq=64)
    params = jax.jit(JaxGPTLM(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    model = tm.GPTLM(tcfg, device="cpu")
    model.load_state_dict(tm.params_from_flax(params, tcfg))
    prompts = [p.tolist() for p in
               np.random.default_rng(0).integers(0, 512, (3, 8))]
    prompts[2] = prompts[2][:5]
    return jcfg, params, model, prompts


_SMALL = dict(max_slots=2, max_queue=8, block_size=4, prefill_chunk=4,
              max_context=64)


def _drain(engine, reqs, max_steps=500):
    """Drive the scheduler synchronously until every request is done."""
    for _ in range(max_steps):
        if all(r._done.is_set() for r in reqs):
            return
        engine.step()
    raise AssertionError("engine did not finish within max_steps")


def test_engine_tokens_equal_jax_engine_and_generate(served):
    """Three requests on two slots: the third waits for a freed slot.
    Greedy tokens equal the JAX engine's and the port's dense generate,
    and no slot or block leaks."""
    jcfg, params, model, prompts = served
    new = [6, 3, 5]
    eng = Engine(model, **_SMALL)
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, new)]
    _drain(eng, reqs)
    jeng = JaxEngine(params, jcfg, **_SMALL)
    jreqs = [jeng.submit(p, max_new_tokens=n) for p, n in zip(prompts, new)]
    _drain(jeng, jreqs)
    for r, jr, p, n in zip(reqs, jreqs, prompts, new):
        assert r.status == jr.status == "ok"
        assert r.finish_reason == "length" and len(r.tokens) == n
        assert r.tokens == jr.tokens
        dense = tm.generate(model, [p], max_new_tokens=n)[0, len(p):]
        assert r.tokens == dense.tolist()
    assert eng.occupancy_max == 2
    assert eng.counters["admits_into_freed_slot"] >= 1
    assert all(s is None for s in eng._slots)
    assert eng.kv.allocator.used_blocks == 0
    assert eng.kv.allocator.free_blocks == eng.kv.allocator.num_blocks


def test_eos_finishes_early_and_frees_blocks(served):
    _, _, model, prompts = served
    eng = Engine(model, **_SMALL)
    probe = eng.submit(prompts[0], max_new_tokens=4)
    _drain(eng, [probe])
    eos = probe.tokens[1]  # a token the greedy run emits early
    req = eng.submit(prompts[0], max_new_tokens=16, eos_token_id=eos)
    _drain(eng, [req])
    assert req.status == "ok" and req.finish_reason == "eos"
    assert req.tokens[-1] == eos and len(req.tokens) <= 2
    assert eng.kv.allocator.used_blocks == 0


def test_seeded_sampling_is_deterministic_and_matches_jax(served):
    """Host sampling draws from the request's np.random.default_rng(seed)
    over the shared fp32 probabilities, so a seed repeats its tokens and
    (logits agreeing to ~1e-6) reproduces the JAX engine's draws."""
    jcfg, params, model, prompts = served
    kw = dict(max_new_tokens=8, temperature=0.9, top_k=40)

    def run(seed):
        eng = Engine(model, **_SMALL)
        r = eng.submit(prompts[1], seed=seed, **kw)
        _drain(eng, [r])
        return r.tokens

    a = run(11)
    assert a == run(11) and a != run(12)
    jeng = JaxEngine(params, jcfg, **_SMALL)
    jr = jeng.submit(prompts[1], seed=11, **kw)
    _drain(jeng, [jr])
    assert a == jr.tokens


def test_gather_cache_rebuilds_the_dense_prefill_cache(served):
    """The pool -> dense-cache gather (what lets prefill chunks of
    different requests interleave) restores exactly the K/V that an
    uninterrupted prefill left, and the next chunk's logits agree."""
    _, _, model, prompts = served
    cfg = model.cfg
    kv = PagedKVCache(num_layers=cfg.num_layers, kv_heads=cfg.kv_heads,
                      head_dim=cfg.head_dim, max_slots=1, num_blocks=16,
                      block_size=4, max_context=64, device="cpu")
    kv.admit(0, 12)
    table = kv.block_tables[0]
    prefill = make_prefill_fn(cfg, chunk=4, block_size=4)
    toks = torch.tensor([prompts[0] + prompts[1][:4]])
    straight = model.init_cache(1, 64)
    for start in (0, 4):
        prefill(model, kv.k_pool, kv.v_pool, straight,
                toks[:, start:start + 4], start, table, 3)
    gathered = make_gather_cache_fn(cfg, block_size=4)(
        kv.k_pool, kv.v_pool, model.init_cache(1, 64), table, 8)
    for name, layer in gathered.items():
        assert layer["attn"]["cache_index"] == 8
        for key in ("cached_key", "cached_value"):
            assert torch.equal(layer["attn"][key][:, :, :8],
                               straight[name]["attn"][key][:, :, :8])
    last = [prefill(model, kv.k_pool, kv.v_pool, cache, toks[:, 8:], 8,
                    table, 3) for cache in (straight, gathered)]
    assert torch.equal(last[0], last[1])


def test_logits_to_probs_matches_jax_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 50)).astype(np.float32) * 3
    temp = np.array([0.0, 0.7, 1.3], np.float32)
    top_k = np.array([0, 5, 0], np.int32)
    np.testing.assert_array_equal(
        logits_to_probs(logits, temp, top_k),
        np.asarray(jax_logits_to_probs(logits, temp, top_k, xp=np)))


def test_fifo_admission_and_queue_full(served):
    _, _, model, prompts = served
    eng = Engine(model, **{**_SMALL, "max_slots": 1, "max_queue": 2})
    a = eng.submit(prompts[0], max_new_tokens=4)
    b = eng.submit(prompts[0][:3], max_new_tokens=2)  # smaller, later
    with pytest.raises(QueueFullError, match="queue full"):
        eng.submit(prompts[0], max_new_tokens=2)
    assert eng.counters["rejected"] == 1
    _drain(eng, [a, b])
    assert a.t_admit <= b.t_admit and a.t_done <= b.t_done


def test_submit_validation(served):
    _, _, model, _ = served
    eng = Engine(model, **_SMALL, max_new_cap=4)
    for kw, match in [
        (dict(prompt=[], max_new_tokens=2), "non-empty"),
        (dict(prompt=[600], max_new_tokens=2), "in \\[0"),
        (dict(prompt=[1, 2], max_new_tokens=0), "max_new_tokens"),
        (dict(prompt=[1] * 62, max_new_tokens=3), "max_context"),
        (dict(prompt=[1, 2], max_new_tokens=8), "cap"),
        (dict(prompt=[1, 2], max_new_tokens=2, top_k=600), "top_k"),
        (dict(prompt=[1, 2], max_new_tokens=2, temperature=-1.0),
         "temperature"),
        (dict(prompt=[1, 2], max_new_tokens=2, eos_token_id=600), "eos"),
    ]:
        with pytest.raises(ValueError, match=match):
            eng.submit(kw.pop("prompt"), **kw)


def test_engine_thread_serves_and_stops(served):
    _, _, model, prompts = served
    eng = Engine(model, **_SMALL).start()
    try:
        req = eng.generate(prompts[2], max_new_tokens=3, timeout=60)
    finally:
        eng.stop(timeout=60)
    assert req.status == "ok" and len(req.tokens) == 3
    assert eng._thread is None
    with pytest.raises(RuntimeError, match="stopped"):
        eng.submit(prompts[2], max_new_tokens=1)


# ----------------------------------------------------- import and device rules

_BANNED = {"jax", "flax", "optax", "orbax", "safetensors", "tensorflow",
           "distributedtensorflow_tpu", "bench", "bench_probe"}


def _imports(path):
    """Top-level module names a file imports (import statements and
    ``__import__``/``importlib.import_module`` of a constant)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", "")
            if name in ("__import__", "import_module"):
                yield node.args[0].value.split(".")[0]


def test_port_imports_no_jax():
    files = sorted((ROOT / "distributedtensorflow_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "train_torch.py",
              ROOT / "serve_torch.py"]
    assert len(files) > 10
    assert ROOT / "serve_torch.py" in files
    port = ROOT / "distributedtensorflow_tpu_torch"
    for sub in ("checkpoint/integrity.py", "checkpoint/manager.py",
                "checkpoint/preemption.py", "utils/determinism.py",
                "utils/watchdog.py", "utils/profiler.py",
                "train/trainer.py", "obs/__init__.py", "obs/registry.py",
                "obs/tracing.py", "obs/anomaly.py", "obs/flight_recorder.py",
                "obs/goodput.py", "obs/aggregate.py", "obs/mfu.py",
                "obs/memory.py", "obs/capture.py", "obs/server.py",
                "obs/usage.py", "serve/draft.py", "serve/server.py",
                "models/bert_moe.py", "native/__init__.py", "native/lib.py",
                "native/recordio.py", "data/wire.py",
                "data/recordio_dataset.py", "net/__init__.py",
                "net/breaker.py", "net/rpc.py", "obs/tsdb.py",
                "obs/slo.py", "obs/alerts.py", "obs/fleet.py",
                "obs/dynamics.py", "parallel/ring_attention.py",
                "parallel/moe.py", "data/adaptive.py", "data/service.py",
                "native/ringcomm.py", "testing/multi_process_runner.py",
                "strategies.py", "parallel/pipeline_mpmd.py",
                "resilience/__init__.py", "resilience/chaos.py",
                "resilience/supervisor.py"):
        assert port / sub in files
    found = {str(f.relative_to(ROOT)): sorted(set(_imports(f)) & _BANNED)
             for f in files}
    assert not {f: m for f, m in found.items() if m}


def test_import_scan_catches_jax(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import os\nfrom jax import numpy\n"
                   "m = __import__('distributedtensorflow_tpu.ops')\n")
    assert set(_imports(bad)) & _BANNED == {"jax", "distributedtensorflow_tpu"}


def test_device_rule(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.GPTLM(tm.gpt_tiny())


def test_paged_kv_cache_defaults_to_the_card(monkeypatch):
    """PagedKVCache resolves its device like every entry point: cuda
    unless the caller asks for the CPU."""
    kv = _kv()
    assert kv.k_pool.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVCache(num_layers=1, kv_heads=2, head_dim=4, max_slots=1,
                     num_blocks=4, block_size=4, max_context=8)
