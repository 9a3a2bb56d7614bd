#!/usr/bin/env python3
"""chip_smoke.py - drive the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: the card's name and power limit, as nvidia-smi prints them;
2. build: every CUDA kernel of the serving path, compiled with nvcc for
   sm_90a from ``distributedtensorflow_tpu_torch/csrc`` into
   ``build/torch_kernels/``;
3. kernels: each kernel against its plain PyTorch version on the same
   inputs at the serving path's shapes, with its time, the plain
   version's, one PyTorch library call's, and its bound (the least time
   the card could take: bytes over 3.35 TB/s or operations over the peak
   rate of their type);
4. serving: the paged continuous-batching ``Engine`` at full
   GPT-2-small width (bf16, seeded random weights) answers six requests;
5. dense generate: ``generate`` at full width, batch 4;
6. profile: torch.profiler over a serving and a generate window (wall
   time, device-busy time, the kernels that take it);
7. consistency (fp32, full width): the engine's greedy tokens equal
   ``generate``'s, and the model's logits on the card agree with the
   plain path on the CPU.

Kernel launch counts are set to 0 just before phases 4 and 5 and read
just after; a kernel of the path that did not launch fails the run.  The
line before the last is one JSON object with a row per kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core rate
              "float32": 67e12}    # outside the tensor cores
L2_BYTES = 50 * 2**20
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(dtype).removeprefix("torch.")]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def time_ms(torch, fn, arg_sets, iters=40, reps=5, graph=True) -> float:
    """Median over ``reps`` of the mean time per call of ``iters`` calls,
    by CUDA events, cycling through ``arg_sets`` (several copies keep the
    inputs of a call out of L2 where the caller would find them cold).
    ``graph=True`` captures the calls in a CUDA graph and times its
    replay: the device's time, without the host's launch overhead;
    ``graph=False`` times eager calls, host overhead included."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()

    def calls():
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])

    run = calls
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            calls()
        run = g.replay
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def bf16_ulp_err(torch, got, ref):
    """Max of |got - ref| in units of one bf16 ulp of ``ref``."""
    _, exp = torch.frexp(ref.float().abs().clamp_min(2.0**-100))
    ulp = torch.ldexp(torch.ones_like(ref, dtype=torch.float32), exp - 8)
    return ((got.float() - ref.float()).abs() / ulp).max().item()


def check_layernorm(torch, F, ln):
    rows = []
    g = torch.Generator(device="cuda").manual_seed(SEED)
    d = 768
    gamma = 1.0 + 0.1 * torch.randn(d, device="cuda", generator=g)
    beta = 0.1 * torch.randn(d, device="cuda", generator=g)
    for n in (4, 16, 64):
        for out_dtype in (torch.bfloat16, torch.float32):
            x = (2.0 * torch.randn(n, d, device="cuda", generator=g)
                 + 0.5).to(torch.bfloat16)
            got = ln.layer_norm_cuda(x, gamma, beta, 1e-6, out_dtype)
            ref = ln._plain_layer_norm(x, gamma, beta, 1e-6, out_dtype)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            if out_dtype == torch.bfloat16:
                ulps = bf16_ulp_err(torch, got, ref)
                ok, tol = ulps <= 1.0, "1 bf16 ulp of the plain value"
            else:
                ok = torch.allclose(got, ref, rtol=1e-5, atol=1e-5)
                ulps, tol = None, "atol 1e-5 + rtol 1e-5"
            g_lib, b_lib = gamma.to(x.dtype), beta.to(x.dtype)
            nbytes = n * d * (x.element_size() + got.element_size()) + 2 * d * 4
            bms, by = bound_ms(nbytes, 8 * n * d, torch.float32)
            row = {
                "kernel": "layernorm_fwd", "n": n, "d": d,
                "in": "bfloat16", "out": str(out_dtype)[6:],
                "max_abs_err": err, "max_bf16_ulps": ulps, "tolerance": tol,
                "ms": time_ms(torch, ln.layer_norm_cuda,
                              [(x, gamma, beta, 1e-6, out_dtype)]),
                "eager_ms": time_ms(torch, ln.layer_norm_cuda,
                                    [(x, gamma, beta, 1e-6, out_dtype)],
                                    graph=False),
                "plain_ms": time_ms(torch, ln._plain_layer_norm,
                                    [(x, gamma, beta, 1e-6, out_dtype)]),
                "library_ms": time_ms(
                    torch, lambda a: F.layer_norm(a, (d,), g_lib, b_lib, 1e-6),
                    [(x,)]),
                "bound_ms": bms, "bound_by": by,
            }
            emit(row)
            if not ok:
                raise AssertionError(f"layernorm kernel disagrees: {row}")
            rows.append(row)
    return rows


def check_decode_attention(torch, F, attn):
    rows = []
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    b, h, s, d = 4, 12, 2048, 64
    cases = [("mha", torch.bfloat16, 12, 0, s),
             ("gqa", torch.bfloat16, 4, 0, s),
             ("window", torch.bfloat16, 12, s - 512, s),
             ("partial", torch.bfloat16, 4, 0, 1000),
             ("mha_fp32", torch.float32, 12, 0, s)]
    for name, dtype, h_kv, lo, hi in cases:
        q = torch.randn(b, 1, h, d, device="cuda", generator=g).to(dtype)
        kv_bytes = 2 * b * h_kv * s * d * q.element_size()
        copies = max(1, -(-3 * L2_BYTES // kv_bytes))
        sets = []
        for _ in range(copies):
            k = torch.randn(b, h_kv, s, d, device="cuda", generator=g).to(dtype)
            v = torch.randn(b, h_kv, s, d, device="cuda", generator=g).to(dtype)
            sets.append((q, k, v, lo, hi))
        got = attn.decode_attention_cuda(*sets[0])
        ref = attn._plain_decode_attention(*sets[0])
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
        mask = torch.zeros(1, 1, 1, s, dtype=torch.bool, device="cuda")
        mask[..., lo:hi] = True

        def sdpa(q, k, v, lo, hi, mask=mask, gqa=h != h_kv):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k, v, attn_mask=mask, enable_gqa=gqa)

        n = hi - lo
        nbytes = 2 * b * h * d * q.element_size() \
            + 2 * b * h_kv * n * d * q.element_size()
        bms, by = bound_ms(nbytes, 4 * b * h * n * d + 5 * b * h * n, dtype)
        row = {
            "kernel": "decode_attention", "case": name, "b": b, "h": h,
            "h_kv": h_kv, "s": s, "d": d, "lo": lo, "hi": hi,
            "dtype": str(dtype)[6:], "max_abs_err": err,
            "tolerance": f"atol {tol}",
            "ms": time_ms(torch, attn.decode_attention_cuda, sets),
            "eager_ms": time_ms(torch, attn.decode_attention_cuda, sets,
                                graph=False),
            "plain_ms": time_ms(torch, attn._plain_decode_attention, sets),
            "library_ms": time_ms(torch, sdpa, sets),
            "bound_ms": bms, "bound_by": by,
        }
        emit(row)
        if not err <= tol:
            raise AssertionError(f"decode attention kernel disagrees: {row}")
        rows.append(row)
    return rows


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_serving(torch, cuda, Engine, model, vocab):
    rng = np.random.default_rng(SEED)
    eng = Engine(model, max_slots=4, block_size=16, prefill_chunk=16,
                 max_context=2048)
    eng.start()
    try:
        # one short request first, so one-time set-up is not timed
        warm = eng.submit([1, 2, 3], max_new_tokens=2)
        if not warm.wait(600) or warm.status != "ok":
            raise AssertionError(f"warm-up request failed: {warm}")
        sync(torch, model.device)
        cuda.launches.clear()
        steps0 = eng.decode_steps
        lens = [5, 17, 33, 64, 100, 9]
        t0 = time.time()
        reqs = []
        for i, n in enumerate(lens):
            prompt = rng.integers(0, vocab, n).tolist()
            kw = {"temperature": 0.8, "top_k": 40, "seed": 7} if i == 5 else {}
            reqs.append(eng.submit(prompt, max_new_tokens=32, **kw))
        for r in reqs:
            if not r.wait(600):
                raise AssertionError(f"request {r.id} did not finish")
        sync(torch, model.device)
        wall = time.time() - t0
        launches = dict(cuda.launches)
    finally:
        eng.stop()
    bad = [(r.id, r.status, r.error) for r in reqs if r.status != "ok"]
    if bad:
        raise AssertionError(f"requests failed: {bad}")
    for r in reqs:
        if len(r.tokens) != 32 or not all(0 <= t < vocab for t in r.tokens):
            raise AssertionError(f"request {r.id} returned {r.tokens}")
    alloc = eng.kv.allocator
    if alloc.used_blocks or alloc.free_blocks != alloc.num_blocks:
        raise AssertionError(f"blocks leaked: {eng.kv.stats()}")
    if not launches.get("layernorm_fwd"):
        raise AssertionError(f"serving ran no layernorm kernel: {launches}")
    steps = eng.decode_steps - steps0
    tokens = sum(len(r.tokens) for r in reqs)
    emit({"phase": "serving", "requests": len(reqs), "status": "ok",
          "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
          "ttft_s": [r.ttft_s for r in reqs],
          "tpot_ms": [1e3 * r.tpot_s for r in reqs],
          "decode_steps": steps, "prefill_chunks": eng.prefill_chunks,
          "launches": launches})
    return launches


def run_generate(torch, cuda, generate, model, vocab):
    g = torch.Generator(device=model.device).manual_seed(SEED + 2)
    prompt = torch.randint(0, vocab, (4, 16), device=model.device,
                           generator=g)
    generate(model, prompt, max_new_tokens=2)  # warm-up
    sync(torch, model.device)
    cuda.launches.clear()
    t0 = time.time()
    out = generate(model, prompt, max_new_tokens=32)
    sync(torch, model.device)
    wall = time.time() - t0
    launches = dict(cuda.launches)
    if out.shape != (4, 48) or not torch.equal(out[:, :16], prompt) \
            or int(out.min()) < 0 or int(out.max()) >= vocab:
        raise AssertionError(f"generate returned {tuple(out.shape)} {out}")
    for k in ("layernorm_fwd", "decode_attention"):
        if not launches.get(k):
            raise AssertionError(f"generate ran no {k} kernel: {launches}")
    emit({"phase": "generate", "batch": 4, "prompt": 16, "new_tokens": 32,
          "wall_s": wall, "ms_per_token_step": 1e3 * wall / 47,
          "tokens_per_s": 4 * 32 / wall, "launches": launches})
    return launches


def run_profile(torch, Engine, generate, model, vocab):
    """torch.profiler over a serving window and a dense-generate window
    at full width: wall time, device-busy time (sum of kernel times on
    the one stream), and the kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED + 4)

    def serve():
        eng = Engine(model, max_slots=4, block_size=16, prefill_chunk=16,
                     max_context=2048)
        reqs = [eng.submit(rng.integers(0, vocab, n).tolist(),
                           max_new_tokens=16) for n in (5, 17, 33, 64)]
        while not all(r._done.is_set() for r in reqs):
            eng.step()

    prompt = torch.as_tensor(rng.integers(0, vocab, (4, 16)),
                             device=model.device)
    for name, fn in (("serving", serve),
                     ("generate", lambda: generate(model, prompt,
                                                   max_new_tokens=16))):
        fn()  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            wall = time.time() - t0
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
        emit({"phase": f"profile_{name}", "wall_ms": 1e3 * wall,
              "device_busy_ms": busy,
              "device_idle_share": 1.0 - busy / (1e3 * wall),
              "top_kernels": [{"name": e.key[:80], "calls": e.count,
                               "ms": e.self_device_time_total / 1e3}
                              for e in top]})


def run_consistency(torch, mods, Engine, cfg, state, device="cuda"):
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    model = mods.GPTLM(cfg, device=device)
    model.load_state_dict(state)
    vocab = cfg.vocab_size
    rng = np.random.default_rng(SEED + 3)
    prompts = rng.integers(0, vocab, (2, 8))
    dense = mods.generate(model, prompts, max_new_tokens=8).cpu().numpy()
    eng = Engine(model, max_slots=2, block_size=16, prefill_chunk=16,
                      max_context=2048)
    reqs = [eng.submit(p.tolist(), max_new_tokens=8) for p in prompts]
    for _ in range(200):
        if all(r._done.is_set() for r in reqs):
            break
        eng.step()
    engine_tokens = [r.tokens for r in reqs]
    if engine_tokens != [list(row[8:]) for row in dense]:
        raise AssertionError(
            f"engine {engine_tokens} != generate {dense[:, 8:].tolist()}")
    # the kernels' path on the card against the plain path on the CPU
    ids = torch.as_tensor(prompts)
    pos = torch.arange(8).expand(2, 8)
    card, _ = mods.prefill(model, ids.to(device), pos.to(device))
    cpu_model = mods.GPTLM(cfg, device="cpu")
    cpu_model.load_state_dict(state)
    ref, _ = mods.prefill(cpu_model, ids, pos)
    err = (card.cpu() - ref).abs().max().item()
    ok = err <= 1e-3 and bool(torch.isfinite(card).all())
    emit({"phase": "consistency", "dtype": "float32",
          "engine_equals_generate": True, "tokens": engine_tokens,
          "card_vs_cpu_logits_max_abs_err": err, "tolerance": "atol 1e-3"})
    if not ok:
        raise AssertionError(f"card logits differ from the CPU's by {err}")


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from distributedtensorflow_tpu_torch import models as mods
    from distributedtensorflow_tpu_torch.ops import _cuda
    from distributedtensorflow_tpu_torch.ops import attention as attn
    from distributedtensorflow_tpu_torch.ops import layernorm as ln
    from distributedtensorflow_tpu_torch.serve import Engine

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32})

    t0 = time.time()
    reports = _cuda.build()
    for name, text in reports.items():
        print(f"--- nvcc {name}\n{text.strip()}", flush=True)
    emit({"phase": "build", "seconds": time.time() - t0,
          "built": sorted(reports)})

    ln_rows = check_layernorm(torch, F, ln)
    at_rows = check_decode_attention(torch, F, attn)

    cfg = mods.gpt_small()
    state = mods.init_params(cfg, torch.Generator().manual_seed(SEED))
    model = mods.GPTLM(cfg)
    model.load_state_dict(state)
    serve_launches = run_serving(torch, _cuda, Engine, model, cfg.vocab_size)
    gen_launches = run_generate(torch, _cuda, mods.generate, model,
                                cfg.vocab_size)
    run_profile(torch, Engine, mods.generate, model, cfg.vocab_size)
    del model
    torch.cuda.empty_cache()
    run_consistency(torch, mods, Engine, cfg, state)

    def summary(name, row, route_src, replaces):
        return {
            "name": name, "route": "cuda", "source": route_src,
            "replaces": replaces,
            "launches": serve_launches.get(name, 0)
            + gen_launches.get(name, 0),
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        }

    print(smi, flush=True)
    emit({"kernels": [
        summary("layernorm_fwd", ln_rows[0],
                "distributedtensorflow_tpu_torch/csrc/layernorm_fwd.cu",
                "distributedtensorflow_tpu/ops/layernorm.py:48"),
        summary("decode_attention", at_rows[0],
                "distributedtensorflow_tpu_torch/csrc/decode_attention.cu",
                "distributedtensorflow_tpu/ops/attention.py:279"),
    ]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
