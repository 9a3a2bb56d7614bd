#!/usr/bin/env python3
"""chip_smoke.py - drive the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: the card's name and power limit, as nvidia-smi prints them;
2. build: every CUDA kernel of the serving and training paths (eight
   libraries), compiled with nvcc for sm_90a from
   ``distributedtensorflow_tpu_torch/csrc`` into ``build/torch_kernels/``,
   one nvcc per source, all started together; the SASS of the bf16 K4f
   and K4b kernels must hold wgmma (HGMMA) and TMA loads (UTMALDG);
3. layernorm and kernels: each kernel against its plain PyTorch version
   on the same inputs at its path's shapes, with its time, the plain
   version's, one PyTorch library call's, and its bound (the least time
   the card could take: bytes over 3.35 TB/s or operations over the peak
   rate of their type): the LayerNorm forward at the serving shapes, a
   GPT training step's rows and a BERT microbatch's (32768 x 768, fp32
   in and out), the LayerNorm backward at the GPT step's and the BERT
   microbatch's (fp32 x and dy; its two launches timed apart); decode attention at the serving
   shapes, the flash-attention forward, the
   split backward's dq and dk/dv kernels and the single-sweep backward
   K3f at the training step's, and the flash kernels again at
   lm_long_context's S 8192 (in bf16 the forward and K3f run on the
   tensor cores, each row says which version ran); then, for the record,
   the flash kernels' forward plus backward against the plain attention
   at S 256, 512 and 1024;
4. xent: the fused LM head's kernels (forward, dx, dw) at gpt_lm's head
   (16376 tokens, D 768, V 50257, bf16), at D 128 and 1024, in fp32 and
   at a ragged token count, the same way (in bf16 all three run on wgmma
   and TMA, dx and dw with a cluster split over D; each row names its
   plan);
5. serving: the paged continuous-batching ``Engine`` at full
   GPT-2-small width (bf16, seeded random weights) answers six requests;
6. dense generate: ``generate`` at full width, batch 4 (K5 launched
   once a layer and one-token step); generate_gqa: gpt_small with one kv
   head, batch 2, a 6000-token prompt in a cache of 8192, 16 greedy
   tokens under ``DECODE_IMPL`` "auto" (K5) and "xla" (einsum path):
   the same tokens, the next logits within 1e-2;
7. profile: torch.profiler over a serving and a generate window (wall
   time, device-busy time, the kernels that take it);
8. consistency (fp32, full width): the engine's greedy tokens equal
   ``generate``'s, and the model's logits on the card agree with the
   plain path on the CPU;
9. train: ``train_torch``'s step on full-width GPT-2-small at the
   gpt_lm preset defaults (bf16, block remat, the fused head) at seq
   2048, batch 8, synthetic batches: one warm-up step and four timed
   ones, losses finite and falling, step time, tokens/s and MFU, and the
   kernels' launches per step (the backward is K3f); profile_train:
   torch.profiler over two steps; then the same four steps and profile
   with the chunked head, for the record; train_split: the same steps
   with ``BACKWARD_IMPL = "pallas_split"`` (the split pair, K3f not
   launched), timed beside K3f's;
10. train_medium: gpt_medium_lm at full width (24 layers, hidden 1024),
    batch 8, seq 2048, one warm-up and three steps; train_long:
    lm_long_context at its defaults (seq 8192, attention-only remat,
    flash forced, fused head), batch 2, one warm-up and two steps, then
    again with the split pair; losses finite and falling, the head and
    flash kernels launched;
11. train_moe: gpt_moe at its defaults (GPT-2-small, eight experts with
    top-2 routing on every second block), batch 8, seq 2048, one warm-up
    and three steps, the same launches per step as gpt_lm; losses finite
    and the LM part falling (the routers' load-balancing term, reported
    beside it, grows over the first steps); its MFU counts two of the
    eight experts per token; profile_train_moe;
12. consistency_train (fp32, full width, 2 layers, B=1, S=1024, flash
    kernels forced): with the chunked head, the fused head, the fused
    head with the split pair, and gpt_moe's layers (1 dense, 1 MoE) with
    the fused head: loss and every gradient on the card agree with the
    plain path on the CPU, and the MoE block routes every token to the
    same experts on both; consistency_bf16 (bf16, full width, 2 layers,
    B=2, S=2048): the loss through the flash kernels agrees with the loss
    through the plain attention, both on the card.

13. baseline: the BASELINE.json presets through ``train_torch.build`` at
    full width and their defaults but the batch: mnist_lenet (batch 128,
    fp32) and cifar_resnet20 (256, bf16), 1+5 steps; imagenet_resnet50
    (224x224, bf16, 256 of the preset's global 1024), 1+3;
    bert_mlm and bert_mlm_packed (BERT-base, seq 512, 256 in four
    microbatches), 1+2; widedeep (the full tables, 4096), 1+5.  Each
    prints its step ms, examples/s (and tokens/s for BERT), its flops per
    step counted by ``FlopCounterMode`` over the warm-up step, MFU and
    peak memory; its losses must be finite, the warm-up batch's loss must
    fall over the steps, every BatchNorm buffer must move, and each BERT
    step launches K1f and K1b 104 times (26 LayerNorms a microbatch) and
    no other kernel.  profile_imagenet_resnet50 and profile_bert_mlm:
    torch.profiler over two steps.  baseline_gate512: bert_mlm_packed
    again with ``MIN_SEQ_FOR_PALLAS`` at 512 (K2 and K3f 48 times a step,
    non-causal with segment ids), its warm-up loss within 1e-2 of the
    default run's.  consistency_baseline (fp32): ImageNetResNet at stage
    sizes (1, 1, 1, 1), 64x64, and BERT-base cut to 2 layers (K1f and K1b
    on the card): loss, gradients and running statistics on the card
    against the CPU's.
14. dp: data parallelism.  dp_world1: gpt_lm as phase 9 runs it, through
    ``--mesh data=1`` over NCCL (bootstrap, mesh, the packed all-reduce
    of the gradients): the five losses equal phase 9's bit for bit, the
    step time beside phase 9's, the packed all-reduce of 124M fp32
    gradients timed and profiled on its own.  dp_gloo2: two ranks on the
    one card over gloo, two processes of this script (``--dp-worker``)
    with torchrun's variables, train gpt_lm (K1f, K1b, K2, K3f, K4f, K4b
    in fp32), bert_mlm_packed (four microbatches, the flash gate at 512),
    cifar_resnet20 (BatchNorm over the global batch) and gpt_moe (global
    routing), fp32, 2 layers, dropout 0, 3 steps, against the one-process
    step on the same global batch: losses within 1e-5 relative, BatchNorm
    buffers within 1e-5 of their max-abs and equal on both ranks, each
    kernel's launches per step and rank as derived; cifar_resnet20 again
    in its preset's bf16, within 1e-2.
15. ckpt: checkpoint and resume on gpt_lm as phase 9 builds it.
    (a) six steps uninterrupted, twice (bit-identical), against three
    steps, an async save, a fresh build whose weights come from another
    seed, ``restore``, ``skip_batches`` and three more: losses and the
    state's ``tree_fingerprint`` bit for bit, the resumed steps launching
    phase 9's kernels their derived counts; the steps around the save
    equal the uninterrupted run's.  (b) ``train_torch.main`` in a child
    (full width, 2 layers, 8 steps, ``--checkpoint-dir``) gets SIGTERM
    after its third step line, saves at the next step boundary and exits
    0; relaunched, it logs the restore and the fast-forward and ends on
    the last loss of an uninterrupted child.  (c) a flipped byte in the
    newest step is rejected and the step before restored; a directory
    without its commit marker is no step.  (d) the checkpoint's bytes,
    the blocking ms of async and sync saves, the background commit, the
    restore, the fast-forward, a step overlapping a commit beside one
    that does not.  ckpt_determinism: two steps of every preset under
    ``--deterministic`` in a fresh process; an op without a deterministic
    CUDA version is recorded by preset.

Kernel launch counts are set to 0 just before phases 5, 6 (each
generate run), 9-11, 13, 14 (each path; in each rank's process) and
15's resumed steps, and read just after; a kernel of the path that did not launch, or a gpt_lm,
gpt_moe or BERT training step that launched a kernel another number of
times than its forward, recomputation and backward need, fails the run.  The
line before the last is one JSON object with a row per kernel; the last
line is ``{"ok": true, "device": {...}}``.  ``--phases`` runs a subset
(for iterating on one part); the default runs all.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
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


def device_events(torch, prof) -> list:
    """The profiler's averaged device events: kernels and copies, without
    the user annotations (``Optimizer.step#AdamW.step``) whose device span
    covers kernels already counted."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_ms_by_kernel(torch, fn, args, iters=20) -> dict:
    """Device time per call of each kernel that ``fn(*args)`` launches,
    by torch.profiler over ``iters`` eager calls after a warm-up: kernel
    name -> ms (the sum of its launches in a call)."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn(*args)
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / iters
            for e in device_events(torch, prof)}


def bf16_ulp_err(torch, got, ref):
    """Max of |got - ref| in units of one bf16 ulp of ``ref``."""
    _, exp = torch.frexp(ref.float().abs().clamp_min(2.0**-100))
    ulp = torch.ldexp(torch.ones_like(ref, dtype=torch.float32), exp - 8)
    return ((got.float() - ref.float()).abs() / ulp).max().item()


#: Libraries whose bf16 kernels must run on wgmma (HGMMA) and TMA
#: (UTMALDG): library -> (kernel name, instantiations).
SASS_KERNELS = {"fused_xent_bwd": ("xent_bwd_wgmma_kernel", 6),  # 3 widths, dx, dw
                "fused_xent_fwd": ("xent_fwd_wgmma_kernel", 1)}


def check_sass(cuda) -> None:
    """Read the SASS of the fused head's libraries with ``cuobjdump
    -sass`` where the toolkit has it: each bf16 K4b kernel
    (``xent_bwd_wgmma_kernel``) and each bf16 K4f kernel
    (``xent_fwd_wgmma_kernel``) must hold warpgroup products (``HGMMA``)
    and TMA loads (``UTMALDG``)."""
    import os
    import shutil

    from torch.utils.cpp_extension import CUDA_HOME

    tool = shutil.which("cuobjdump")
    if tool is None:
        path = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
        tool = path if os.path.exists(path) else None
    if tool is None:
        emit({"phase": "sass", "skipped": "no cuobjdump in the toolkit"})
        return
    for library, (kernel, count) in SASS_KERNELS.items():
        text = subprocess.run([tool, "-sass", str(cuda.lib_path(library))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        funcs = {}
        for block in text.split("Function : ")[1:]:
            name, _, body = block.partition("\n")
            funcs[name.strip()] = body
        found = {name: {"HGMMA": "HGMMA" in body, "UTMALDG": "UTMALDG" in body}
                 for name, body in funcs.items() if kernel in name}
        ok = len(found) == count and all(all(v.values())
                                         for v in found.values())
        emit({"phase": "sass", "library": library, "kernels": found,
              "ok": ok})
        if not ok:
            raise AssertionError(f"the bf16 kernels of {library} lack HGMMA "
                                 f"or UTMALDG (or are not {count}): {found}")


def check_layernorm(torch, F, ln):
    rows = []
    g = torch.Generator(device="cuda").manual_seed(SEED)
    d = 768
    gamma = 1.0 + 0.1 * torch.randn(d, device="cuda", generator=g)
    beta = 0.1 * torch.randn(d, device="cuda", generator=g)
    # decode steps; a GPT training step's rows; a BERT microbatch's rows
    # (64 x 512, fp32 in and out: its LayerNorms sum fp32 residuals); the
    # gathered MLM head's (64 x 103 positions, bf16 in, fp32 out)
    cases = [(n, torch.bfloat16, out) for n in (4, 16, 64, 16384)
             for out in (torch.bfloat16, torch.float32)]
    for n, x_dtype, out_dtype in cases + [
            (32768, torch.float32, torch.float32),
            (6592, torch.bfloat16, torch.float32)]:
        x = (2.0 * torch.randn(n, d, device="cuda", generator=g)
             + 0.5).to(x_dtype)
        got = ln.layer_norm_cuda(x, gamma, beta, 1e-6, out_dtype)
        ref = ln._plain_layer_norm(x, gamma, beta, 1e-6, out_dtype)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        if out_dtype == torch.bfloat16 and n <= 64:
            ulps = bf16_ulp_err(torch, got, ref)
            ok, tol = ulps <= 1.0, "1 bf16 ulp of the plain value"
        elif out_dtype == torch.bfloat16:
            # over 12.6M outputs some y = xhat * g + b cancels to near
            # 0, where a few fp32 ulps of another summation order are
            # many bf16 ulps of y: hold each output to one rounding of
            # a value within 1e-5 of the plain fp32 output instead
            ulps = bf16_ulp_err(torch, got, ref)
            ref32 = ln._plain_layer_norm(x, gamma, beta, 1e-6,
                                         torch.float32)
            _, e = torch.frexp(ref32.abs().clamp_min(2.0**-100))
            ulp = torch.ldexp(torch.ones_like(ref32), e - 8)
            ok = bool(((got.float() - ref32).abs() <= 1e-5 + ulp).all())
            tol = ("one bf16 rounding of a value within 1e-5 of the "
                   "plain fp32 output")
            del ref32, e, ulp
        else:
            ok = torch.allclose(got, ref, rtol=1e-5, atol=1e-5)
            ulps, tol = None, "atol 1e-5 + rtol 1e-5"
        g_lib, b_lib = gamma.to(x.dtype), beta.to(x.dtype)
        nbytes = n * d * (x.element_size() + got.element_size()) + 2 * d * 4
        bms, by = bound_ms(nbytes, 8 * n * d, torch.float32)
        row = {
            "kernel": "layernorm_fwd", "n": n, "d": d,
            "in": str(x_dtype)[6:], "out": str(out_dtype)[6:],
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
    """K5 against its plain twin: the serving shapes (gpt_small's generate:
    B 4, H 12, S 2048, D 64) with GQA, a window, a partial band and fp32;
    the groups and bands the first version refused: 12 query heads over 1
    kv head, 16 over 2 at 8192 positions, and 65536 positions at B 1.
    Each case runs three times for bit-identical outputs and names the
    plan (splits of the band) it ran."""
    rows = []
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    bf16, fp32 = torch.bfloat16, torch.float32
    d = 64
    # name, dtype, (B, H, Hkv, S), band
    cases = [("mha", bf16, (4, 12, 12, 2048), (0, 2048)),
             ("gqa", bf16, (4, 12, 4, 2048), (0, 2048)),
             ("window", bf16, (4, 12, 12, 2048), (2048 - 512, 2048)),
             ("partial", bf16, (4, 12, 4, 2048), (0, 1000)),
             ("mha_fp32", fp32, (4, 12, 12, 2048), (0, 2048)),
             ("gqa12", bf16, (4, 12, 1, 2048), (0, 2048)),
             ("gqa8_long", bf16, (4, 16, 2, 8192), (0, 8192)),
             ("long_mha", bf16, (1, 12, 12, 65536), (0, 65536))]
    for name, dtype, (b, h, h_kv, s), (lo, hi) in cases:
        q = torch.randn(b, 1, h, d, device="cuda", generator=g).to(dtype)
        kv_bytes = 2 * b * h_kv * s * d * q.element_size()
        copies = max(1, -(-3 * L2_BYTES // kv_bytes))
        sets = []
        for _ in range(copies):
            k = torch.randn(b, h_kv, s, d, device="cuda", generator=g).to(dtype)
            v = torch.randn(b, h_kv, s, d, device="cuda", generator=g).to(dtype)
            sets.append((q, k, v, lo, hi))
        got = attn.decode_attention_cuda(*sets[0])
        again = [attn.decode_attention_cuda(*sets[0]) for _ in range(2)]
        ref = attn._plain_decode_attention(*sets[0])
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        # relative to the case's largest output: over n positions an output
        # value is about sqrt(e / n) here, so a fixed atol would pass a
        # dropped or misweighted split (or zeros) at 65536 positions; 2**-6
        # of the largest output (two to four bf16 ulps of it) fails them at
        # every length
        rel = _rel_err(got, ref)
        deterministic = all(torch.equal(got, x) for x in again)
        tol = 2.0**-6 if dtype == bf16 else 1e-5
        mask = torch.zeros(1, 1, 1, s, dtype=torch.bool, device="cuda")
        mask[..., lo:hi] = True

        def sdpa(q, k, v, lo, hi, mask=mask, gqa=h != h_kv):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k, v, attn_mask=mask, enable_gqa=gqa)

        n = hi - lo
        splits, chunk = attn.decode_plan(
            b, h, h_kv, d, lo, hi,
            torch.cuda.get_device_properties(0).multi_processor_count)
        nbytes = 2 * b * h * d * q.element_size() \
            + 2 * b * h_kv * n * d * q.element_size()
        bms, by = bound_ms(nbytes, 4 * b * h * n * d + 5 * b * h * n, dtype)
        row = {
            "kernel": "decode_attention", "case": name, "b": b, "h": h,
            "h_kv": h_kv, "s": s, "d": d, "lo": lo, "hi": hi,
            "dtype": str(dtype)[6:], "splits": splits, "chunk": chunk,
            "blocks": b * h_kv * splits, "max_abs_err": err,
            "rel_err": rel, "max_abs_ref": ref.float().abs().max().item(),
            "deterministic": deterministic,
            "tolerance": f"max|got - ref| / max|ref| <= {tol}; "
                         "bit-identical on two reruns",
            "ms": time_ms(torch, attn.decode_attention_cuda, sets),
            "eager_ms": time_ms(torch, attn.decode_attention_cuda, sets,
                                graph=False),
            "plain_ms": time_ms(torch, attn._plain_decode_attention, sets),
            "library_ms": time_ms(torch, sdpa, sets),
            "bound_ms": bms, "bound_by": by,
        }
        emit(row)
        if not (rel <= tol and deterministic):
            raise AssertionError(f"decode attention kernel disagrees: {row}")
        rows.append(row)
        del sets, got, again, ref
        torch.cuda.empty_cache()
    return rows


def check_layernorm_bwd(torch, ln):
    """K1b at the training step's rows: 8 x 2048 tokens of width 768,
    bf16 x with bf16 dy (the blocks' LayerNorms) and fp32 dy (ln_f); at
    a BERT microbatch's, 64 x 512, fp32 x and dy; and at the gathered MLM
    head's, 64 x 103, bf16 x and fp32 dy.
    Each row gives the main pass's grid (``blocks``) and its two
    launches' device times apart (``main_ms``, ``reduce_ms``: the
    profiler's kernel times per call), beside the graph-replay time of
    the pair (``ms``) and, with bf16 dy, the time of one ``torch.add``
    that moves the same bytes (``stream_yardstick_ms``, timed only)."""
    rows = []
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    d = 768
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gamma = 1.0 + 0.1 * torch.randn(d, device="cuda", generator=g)
    beta = 0.1 * torch.randn(d, device="cuda", generator=g)
    bf16, fp32 = torch.bfloat16, torch.float32
    # (rows, x, dy): gpt_lm's blocks and ln_f; a BERT microbatch (64 x
    # 512, fp32 residuals and fp32 cotangents); BERT's gathered MLM head
    # (64 x 103 positions)
    for n, x_dtype, dy_dtype in ((8 * 2048, bf16, bf16),
                                 (8 * 2048, bf16, fp32),
                                 (64 * 512, fp32, fp32),
                                 (64 * 103, bf16, fp32)):
        # a tree from before bwd_blocks ran min(n / 8, 256) blocks
        blocks = ln.bwd_blocks(n, sms) if hasattr(ln, "bwd_blocks") \
            else min(-(-n // 8), 256)
        x = (2.0 * torch.randn(n, d, device="cuda", generator=g)
             + 0.5).to(x_dtype)
        dy = torch.randn(n, d, device="cuda", generator=g).to(dy_dtype)
        dx, dg, db = ln.layer_norm_bwd_cuda(x, gamma, dy, 1e-6)
        rdx, rdg, rdb = ln._plain_layer_norm_bwd(x, gamma, dy, 1e-6)
        again = ln.layer_norm_bwd_cuda(x, gamma, dy, 1e-6)
        torch.cuda.synchronize()
        # dx = rstd * (a - mean(a) - xhat * mean(a * xhat)) cancels: a
        # few fp32 ulps of another summation order can turn into many
        # bf16 ulps of a small entry, so the bound is one bf16 ulp of the
        # largest entry (2**-7 of max|dx|, at most 2**-8 away from it);
        # an fp32 dx is held to 1e-5 of max|dx|
        dx_tol = 2.0**-7 if x_dtype == bf16 else 1e-5
        dx_rel = _rel_err(dx, rdx)
        sum_err = max(((dg - rdg).abs().max() / rdg.abs().max()).item(),
                      ((db - rdb).abs().max() / rdb.abs().max()).item())
        deterministic = all(torch.equal(a, b) for a, b in
                            zip((dx, dg, db), again))
        ok = dx_rel <= dx_tol and sum_err <= 1e-4 and deterministic
        _, mean, rstd = torch.ops.aten.native_layer_norm(
            x, [d], gamma.to(x.dtype), beta.to(x.dtype), 1e-6)
        dy_lib = dy.to(x.dtype)

        def library(dy_lib=dy_lib, x=x, mean=mean, rstd=rstd):
            return torch.ops.aten.native_layer_norm_backward(
                dy_lib, x, [d], mean, rstd, gamma.to(x.dtype),
                beta.to(x.dtype), [True, True, True])

        nbytes = n * d * (2 * x.element_size() + dy.element_size()) \
            + 3 * d * 4
        bms, by = bound_ms(nbytes, 20 * n * d, torch.float32)
        split = device_ms_by_kernel(torch, ln.layer_norm_bwd_cuda,
                                    (x, gamma, dy, 1e-6))
        reduce_ms = sum(v for k, v in split.items() if "reduce" in k)
        # the byte rate one elementwise PyTorch call reaches for the same
        # two reads and one write (bf16 x + bf16 dy into a bf16 tensor)
        stream_ms = None
        if dy_dtype == bf16:
            out = torch.empty_like(x)
            stream_ms = time_ms(torch, lambda a, b: torch.add(a, b, out=out),
                                [(x, dy)])
            del out
        row = {
            "kernel": "layernorm_bwd", "n": n, "d": d, "x": str(x_dtype)[6:],
            "dy": str(dy_dtype)[6:], "blocks": blocks,
            "main_ms": sum(split.values()) - reduce_ms,
            "reduce_ms": reduce_ms,
            "launch_ms": {k[:100]: v for k, v in split.items()},
            "stream_yardstick_ms": stream_ms,
            "max_abs_err": (dx.float() - rdx.float()).abs().max().item(),
            "dx_rel_err": dx_rel, "dgamma_dbeta_rel_err": sum_err,
            "deterministic": deterministic,
            "tolerance": ("dx 2**-7 of max|dx| (one bf16 ulp of the "
                          "largest entry)" if x_dtype == bf16 else
                          "dx 1e-5 of max|dx|")
                         + "; dgamma, dbeta 1e-4 of their max; "
                         "bit-identical on a rerun",
            "ms": time_ms(torch, ln.layer_norm_bwd_cuda,
                          [(x, gamma, dy, 1e-6)]),
            "plain_ms": time_ms(torch, ln._plain_layer_norm_bwd,
                                [(x, gamma, dy, 1e-6)]),
            "library_ms": time_ms(torch, library, [()]),
            "bound_ms": bms, "bound_by": by,
        }
        emit(row)
        if not ok:
            raise AssertionError(f"layernorm backward kernel disagrees: {row}")
        rows.append(row)
    return rows


def _keep(torch, s, causal, window, mask, seg):
    """(B or 1, 1, S, S) bool: the (query, key) pairs the masks leave."""
    q = torch.arange(s, device="cuda")[:, None]
    k = torch.arange(s, device="cuda")[None, :]
    keep = torch.ones((s, s), dtype=torch.bool, device="cuda")
    if causal:
        keep &= k <= q
    if window is not None:
        keep &= k > q - window
    keep = keep[None, None]
    if mask is not None:
        keep = keep & mask[:, None, None, :]
    if seg is not None:
        keep = keep & (seg[:, None, :, None] == seg[:, None, None, :])
    return keep


def _rel_err(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


def check_flash(torch, F, fa):
    """K2, K3 (dq, dk/dv) and K3f at the training step's attention: B=8,
    H=12, S=2048, D=64, causal, bf16; GQA, window and padding cases; fp32
    once; a ragged case (S not a multiple of the 64-row tiles, with GQA,
    window, padding and packed segments at once); D=32 in fp32 and in
    bf16 (with GQA and padding); a case without the causal mask; BERT's
    packed microbatch (B=64, S=512, non-causal, segment ids: the
    ``baseline_gate512`` run's shapes); and the first case again at
    lm_long_context's S=8192 (B=2).  Each row names
    the version that ran (``variant``: "mma", bf16 on the tensor cores, or
    "fma", fp32 products on the CUDA cores), as the port names it.  K3f
    is held against its plain twin, run five times for bit-identical
    outputs, and reported beside the split pair's outputs."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    bf16, fp32 = torch.bfloat16, torch.float32
    # name, dtype, (B, H, Hkv, S, D), window, padding, segment ids, causal
    cases = [("causal", bf16, (8, 12, 12, 2048, 64), None, False, False,
              True),
             ("gqa", bf16, (8, 12, 4, 2048, 64), None, False, False, True),
             ("window", bf16, (8, 12, 12, 2048, 64), 512, False, False, True),
             ("padding", bf16, (8, 12, 12, 2048, 64), None, True, False,
              True),
             ("causal_fp32", fp32, (8, 12, 12, 2048, 64), None, False, False,
              True),
             ("ragged_all_masks", bf16, (2, 12, 4, 1000, 64), 300, True,
              True, True),
             ("d32_fp32", fp32, (2, 4, 2, 256, 32), None, True, False, True),
             ("d32_bf16", bf16, (2, 8, 2, 1024, 32), None, True, False, True),
             ("noncausal", bf16, (2, 12, 12, 1024, 64), None, True, False,
              False),
             # bert_mlm_packed's microbatch with the gate at 512
             ("bert_packed", bf16, (64, 12, 12, 512, 64), None, False, True,
              False),
             ("long_context", bf16, (2, 12, 12, 8192, 64), None, False,
              False, True)]
    rows = {k: [] for k in FLASH_ROWS}
    for name, dtype, (b, h, h_kv, s, d), window, padded, segmented, causal \
            in cases:
        def rnd(*shape):
            return torch.randn(*shape, device="cuda", generator=g).to(dtype)

        q, do = rnd(b, s, h, d), rnd(b, s, h, d)
        k, v = rnd(b, s, h_kv, d), rnd(b, s, h_kv, d)
        mask = seg = None
        if padded:
            lens = torch.randint(s // 2, s + 1, (b,), device="cuda",
                                 generator=g)
            mask = torch.arange(s, device="cuda")[None, :] < lens[:, None]
        if segmented:
            seg = torch.cumsum(torch.rand((b, s), device="cuda", generator=g)
                               < 0.01, dim=1).to(torch.int32)
        kw = dict(mask=mask, segment_ids=seg, causal=causal, window=window)
        o, lse = fa.flash_forward_cuda(q, k, v, *kw.values())
        ro, rlse = fa._plain_flash_forward(q, k, v, *kw.values())
        delta = (do.float() * ro.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        bargs = (q, k, v, do, rlse, delta, *kw.values())
        dq = fa.flash_bwd_dq_cuda(*bargs)
        dk, dv = fa.flash_bwd_dkv_cuda(*bargs)
        fused = fa.flash_bwd_fused_cuda(*bargs)
        dq2 = fa.flash_bwd_dq_cuda(*bargs)
        dk2, dv2 = fa.flash_bwd_dkv_cuda(*bargs)
        fused_again = [fa.flash_bwd_fused_cuda(*bargs) for _ in range(4)]
        torch.cuda.synchronize()
        rdq = fa._plain_flash_bwd_dq(*bargs)
        rdk, rdv = fa._plain_flash_bwd_dkv(*bargs)
        rfused = fa._plain_flash_bwd_fused(*bargs)
        deterministic = all(torch.equal(a, c) for a, c in
                            ((dq, dq2), (dk, dk2), (dv, dv2)))
        fused_deterministic = all(torch.equal(a, c) for again in fused_again
                                  for a, c in zip(fused, again))
        del fused_again
        twins_agree = all(torch.equal(a, c) for a, c in
                          zip(rfused, (rdq, rdk, rdv)))
        # in bf16 the pair's dk/dv kernel and K3f run one dk/dv sweep
        # (flash_common.cuh): the same bits, by construction
        same_dkv = torch.equal(dk, fused[1]) and torch.equal(dv, fused[2])
        o_tol, g_tol = (2e-2, 1e-2) if dtype == bf16 else (2e-5, 1e-4)
        errs = {"o": (o.float() - ro.float()).abs().max().item(),
                "lse": (lse - rlse).abs().max().item(),
                "dq": _rel_err(dq, rdq), "dk": _rel_err(dk, rdk),
                "dv": _rel_err(dv, rdv)}
        fused_errs = {f"{n}_rel_err": _rel_err(a, r)
                      for n, a, r in zip(("dq", "dk", "dv"), fused, rfused)}
        vs_split = {f"{n}_vs_split_rel_err": _rel_err(a, r)
                    for n, a, r in zip(("dq", "dk", "dv"), fused,
                                       (dq, dk, dv))}
        oks = {"flash_fwd": errs["o"] <= o_tol and errs["lse"] <= 1e-3,
               "flash_bwd_dq": errs["dq"] <= g_tol and deterministic,
               "flash_bwd_dkv": max(errs["dk"], errs["dv"]) <= g_tol
               and deterministic and (same_dkv or dtype != bf16),
               "flash_bwd_fused": max(fused_errs.values()) <= g_tol
               and fused_deterministic and twins_agree}
        keep = _keep(torch, s, causal, window, mask, seg)
        # (query, key) pairs over all heads: the work these inputs need
        pairs = float(keep.expand(b, 1, s, s).sum()) * h
        del keep
        el = q.element_size()
        qbytes, kvbytes, rows_bytes = b * s * h * d * el, \
            b * s * h_kv * d * el, b * h * s * 4
        lib_mask = None if window is None and mask is None and seg is None \
            else _keep(torch, s, causal, window, mask, seg)
        gqa = h != h_kv
        qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))

        def sdpa(qt=qt, kt=kt, vt=vt, lib_mask=lib_mask, gqa=gqa):
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=lib_mask,
                is_causal=causal and lib_mask is None, enable_gqa=gqa)

        qr, kr, vr = (x.detach().clone().requires_grad_(True)
                      for x in (qt, kt, vt))
        out_lib = F.scaled_dot_product_attention(
            qr, kr, vr, attn_mask=lib_mask,
            is_causal=causal and lib_mask is None, enable_gqa=gqa)

        def sdpa_bwd(out_lib=out_lib, qr=qr, kr=kr, vr=vr, dot=dot):
            return torch.autograd.grad(out_lib, (qr, kr, vr), dot,
                                       retain_graph=True)

        long = s > 4096
        iters = dict(iters=3, reps=3) if long else dict(iters=10, reps=3)
        # at S 8192 one plain call holds ~30 GB of (B, H, S, S) tiles:
        # timed eagerly, once per rep
        plain_iters = dict(iters=1, reps=3, graph=False) if long \
            else dict(iters=4, reps=3)
        fwd_args = [(q, k, v, *kw.values())]
        lib_bwd_ms = time_ms(torch, sdpa_bwd, [()], graph=False, **iters)
        common = {"case": name, "b": b, "h": h, "h_kv": h_kv, "s": s, "d": d,
                  "dtype": str(dtype)[6:], "causal": causal,
                  "window": window, "padding": padded,
                  "segments": segmented}
        specs = [
            ("flash_fwd", fa.flash_forward_cuda, fa._plain_flash_forward,
             fwd_args, 4 * d * pairs,
             2 * qbytes + 2 * kvbytes + rows_bytes,
             time_ms(torch, sdpa, [()], **iters),
             {"o_max_abs_err": errs["o"], "lse_max_abs_err": errs["lse"],
              "tolerance": f"o atol {o_tol}, lse atol 1e-3"},
             errs["o"]),
            ("flash_bwd_dq", fa.flash_bwd_dq_cuda, fa._plain_flash_bwd_dq,
             [bargs], 6 * d * pairs,
             3 * qbytes + 2 * kvbytes + 2 * rows_bytes, lib_bwd_ms,
             {"dq_rel_err": errs["dq"], "deterministic": deterministic,
              "tolerance": f"{g_tol} of max|dq|; bit-identical on a rerun"},
             (dq.float() - rdq.float()).abs().max().item()),
            ("flash_bwd_dkv", fa.flash_bwd_dkv_cuda, fa._plain_flash_bwd_dkv,
             [bargs], 8 * d * pairs,
             2 * qbytes + 4 * kvbytes + 2 * rows_bytes, lib_bwd_ms,
             {"dk_rel_err": errs["dk"], "dv_rel_err": errs["dv"],
              "deterministic": deterministic, "equals_k3f_dkv": same_dkv,
              "tolerance": f"{g_tol} of max|dk|, max|dv|; bit-identical "
                           "on a rerun" + ("; equal to K3f's dk, dv in bf16"
                                           if dtype == bf16 else "")},
             max((dk.float() - rdk.float()).abs().max().item(),
                 (dv.float() - rdv.float()).abs().max().item())),
            ("flash_bwd_fused", fa.flash_bwd_fused_cuda,
             fa._plain_flash_bwd_fused, [bargs], 10 * d * pairs,
             3 * qbytes + 4 * kvbytes + 2 * rows_bytes, lib_bwd_ms,
             {**fused_errs, **vs_split, "deterministic": fused_deterministic,
              "plain_equals_split_twins": twins_agree,
              "tolerance": f"{g_tol} of max|dq|, max|dk|, max|dv| against "
                           "the plain twin; bit-identical on four reruns; "
                           "the twin equals the split twins bit for bit"},
             max((a.float() - r.float()).abs().max().item()
                 for a, r in zip(fused, rfused))),
        ]
        del rdq, rdk, rdv, rfused
        for kname, kern, plain, args, flops, nbytes, lib_ms, extra, err \
                in specs:
            bms, by = bound_ms(nbytes, flops, dtype)
            row = {"kernel": kname, **common,
                   "variant": fa.kernel_variant(dtype, kname),
                   "max_abs_err": err, **extra,
                   "flops": flops, "ms": time_ms(torch, kern, args, **iters),
                   "plain_ms": time_ms(torch, plain, args, **plain_iters),
                   "library_ms": lib_ms,
                   "library": "F.scaled_dot_product_attention "
                              + ("forward" if kname == "flash_fwd" else
                                 "backward (dq, dk, dv together; eager)"),
                   "bound_ms": bms, "bound_by": by}
            emit(row)
            if not oks[kname]:
                raise AssertionError(f"{kname} kernel disagrees: {row}")
            rows[kname].append(row)
        del out_lib, qr, kr, vr, lib_mask
        torch.cuda.empty_cache()
    return rows


def run_short_seq(torch, fa, attn):
    """For the record (nothing is decided on it): forward plus backward of
    the flash kernels (``flash_attention``: K2, K3f and the delta pass)
    against the plain path ``xla_attention`` below and at the dispatch
    threshold ``MIN_SEQ_FOR_PALLAS``, at the training step's 16384 tokens
    (H 12, D 64, bf16, causal).  Eager calls: the host's launch overhead
    is in both times."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    for s in (256, 512, 1024):
        b = 16384 // s
        q, k, v, do = (torch.randn(b, s, 12, 64, device="cuda", generator=g)
                       .to(torch.bfloat16) for _ in range(4))
        for x in (q, k, v):
            x.requires_grad_(True)

        def flash(q=q, k=k, v=v, do=do):
            return torch.autograd.grad(
                fa.flash_attention(q, k, v, causal=True), (q, k, v), do)

        def plain(q=q, k=k, v=v, do=do):
            return torch.autograd.grad(
                attn.xla_attention(q, k, v, causal=True), (q, k, v), do)

        it = dict(iters=10, reps=3, graph=False)
        emit({"phase": "short_seq", "b": b, "h": 12, "s": s, "d": 64,
              "dtype": "bfloat16", "causal": True,
              "min_seq_for_pallas": fa.MIN_SEQ_FOR_PALLAS,
              "flash_fwd_bwd_ms": time_ms(torch, flash, [()], **it),
              "xla_attention_fwd_bwd_ms": time_ms(torch, plain, [()], **it)})


def run_backward_lengths(torch, F, fa):
    """The split pair (dq plus dk/dv) beside the single sweep K3f and
    SDPA's eager backward at gpt_lm's attention (B 8, S 2048),
    lm_long_context's (B 2, S 8192) and B 1 at S 16384, where S * D * 4
    passes K3f's 2 MiB threshold and JAX takes the pair (H 12, D 64,
    causal, bf16): the numbers the threshold decision waits for.  The
    plain twins' (B, H, S, S) tiles do not fit the card at S 16384, so the
    pair is held against K3f here (1e-2 of max, as both are held against
    the twins at the shorter lengths) and run twice for bit-identical
    outputs."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    rows = []
    for b, s in ((8, 2048), (2, 8192), (1, 16384)):
        h, d = 12, 64
        q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=g)
                       .to(torch.bfloat16) for _ in range(4))
        o, lse = fa.flash_forward_cuda(q, k, v, None, None, True, None)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        bargs = (q, k, v, do, lse, delta, None, None, True, None)

        def pair(*a):
            return (fa.flash_bwd_dq_cuda(*a),) + fa.flash_bwd_dkv_cuda(*a)

        split = pair(*bargs)
        split2 = pair(*bargs)
        fused = fa.flash_bwd_fused_cuda(*bargs)
        torch.cuda.synchronize()
        errs = {f"{n}_vs_k3f_rel_err": _rel_err(a, r)
                for n, a, r in zip(("dq", "dk", "dv"), split, fused)}
        deterministic = all(torch.equal(a, c) for a, c in zip(split, split2))
        del split, split2, fused
        qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
        qr, kr, vr = (x.detach().clone().requires_grad_(True)
                      for x in (qt, kt, vt))
        out_lib = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)

        def sdpa_bwd(out_lib=out_lib, qr=qr, kr=kr, vr=vr, dot=dot):
            return torch.autograd.grad(out_lib, (qr, kr, vr), dot,
                                       retain_graph=True)

        it = dict(iters=3, reps=3) if s > 4096 else dict(iters=10, reps=3)
        pairs = b * h * s * (s + 1) / 2
        el = q.element_size()
        qbytes, rows_bytes = b * s * h * d * el, b * h * s * 4
        pair_bms, _ = bound_ms(11 * qbytes + 4 * rows_bytes,
                               14 * d * pairs, torch.bfloat16)
        fused_bms, _ = bound_ms(7 * qbytes + 2 * rows_bytes, 10 * d * pairs,
                                torch.bfloat16)
        row = {"phase": "flash_bwd_lengths", "b": b, "h": h, "s": s, "d": d,
               "dtype": "bfloat16", "causal": True,
               "variant": fa.kernel_variant(torch.bfloat16, "flash_bwd_dq"),
               "uses_fused_backward": fa.uses_fused_backward(s, d),
               **errs, "deterministic": deterministic,
               "tolerance": "1e-2 of max|dq|, max|dk|, max|dv| of K3f's; "
                            "bit-identical on a rerun",
               "dq_ms": time_ms(torch, fa.flash_bwd_dq_cuda, [bargs], **it),
               "dkv_ms": time_ms(torch, fa.flash_bwd_dkv_cuda, [bargs], **it),
               "k3f_ms": time_ms(torch, fa.flash_bwd_fused_cuda, [bargs],
                                 **it),
               "sdpa_bwd_eager_ms": time_ms(torch, sdpa_bwd, [()],
                                            graph=False, **it),
               "pair_bound_ms": pair_bms, "k3f_bound_ms": fused_bms}
        row["pair_ms"] = row["dq_ms"] + row["dkv_ms"]
        emit(row)
        if not (max(errs.values()) <= 1e-2 and deterministic):
            raise AssertionError(f"the split pair disagrees with K3f: {row}")
        rows.append(row)
        del out_lib, qr, kr, vr, q, k, v, do, o, lse, delta, bargs
        torch.cuda.empty_cache()
    return rows


def _library_logits(torch, x, w, grad):
    """One PyTorch call for the head's logits: operands in their dtype
    with an fp32 result (``mm(out_dtype=)``, which has no derivative), or,
    where the backward is timed too, ``mm`` in the operands' dtype,
    widened.  Timed as a yardstick only; the port never calls it."""
    if grad or x.dtype == torch.float32:
        return torch.mm(x, w.t()).float()
    return torch.mm(x, w.t(), out_dtype=torch.float32)


def check_fused_xent(torch, F, fx):
    """K4f, K4b dx and K4b dw against their plain twins: gpt_lm's head
    (N 16376 = 8 x 2047 tokens, D 768, V 50257, bf16) with a partial mask
    and 1% of the targets at -100; D 128 (gpt_tiny) and D 1024
    (gpt_medium_lm), so every width of ``HIDDEN_SIZES`` runs; fp32
    operands; a ragged N.  Forward values to atol 1e-4 (the same rounded
    operands, another summation order); dx and dw to 5e-4 of their max in
    bf16 (a rounding of dlog to bf16 may flip where p differs in its last
    fp32 bit) and 1e-4 in fp32; lse, tgt, dx and dw bit-identical on a
    rerun.  Each row names its plan (``xent_fwd_plan``: tokens of a block,
    vocab tile, ring stages, cluster; ``xent_bwd_plan``: cluster size,
    owned and streamed rows, ring stages) and ``variant`` ("wgmma" for K4f
    and "wgmma_cluster" for K4b in bf16, "fma" in fp32).  The library
    yardsticks: for K4f one forward call, and beside it ``torch.mm(x,
    w.t())`` alone (cuBLAS, the logits written); for K4b the backward
    alone (``torch.autograd.grad`` on a retained forward graph) and, as in
    earlier runs, forward plus backward.  For
    bf16 the row also reads an unrounded control, the plain products of
    dlog kept in fp32, against the plain twin: it shows how far the limit
    lies below a kernel that skipped dlog's rounding."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [("gpt_lm", bf16, 16376, 768), ("d128", bf16, 16376, 128),
             ("d1024", bf16, 16376, 1024), ("fp32", fp32, 4096, 768),
             ("ragged_n", bf16, 1000, 768)]
    v = 50257
    rows = {"fused_xent_fwd": [], "fused_xent_dx": [], "fused_xent_dw": []}
    for name, dtype, n, d in cases:
        x = torch.randn(n, d, device="cuda", generator=g).to(dtype)
        w = (0.05 * torch.randn(v, d, device="cuda", generator=g)).to(dtype)
        t = torch.randint(0, v, (n,), device="cuda", generator=g,
                          dtype=torch.int32)
        t = torch.where(torch.rand(n, device="cuda", generator=g) < 0.01,
                        -100, t).to(torch.int32)
        w_row = (torch.rand(n, device="cuda", generator=g) > 0.1).float() \
            * ((t >= 0) & (t < v)).float()
        c = w_row / w_row.sum().clamp_min(1.0)
        lse, tgt = fx.xent_fwd_cuda(x, w, t)
        lse2, tgt2 = fx.xent_fwd_cuda(x, w, t)
        rlse, rtgt = fx.xent_fwd_plain(x, w, t)
        bargs = (x, w, t, rlse, c)
        dx, dw = fx.xent_dx_cuda(*bargs), fx.xent_dw_cuda(*bargs)
        rdx, rdw = fx.xent_dx_plain(*bargs), fx.xent_dw_plain(*bargs)
        dx2, dw2 = fx.xent_dx_cuda(*bargs), fx.xent_dw_cuda(*bargs)
        torch.cuda.synchronize()
        deterministic = torch.equal(dx, dx2) and torch.equal(dw, dw2)
        fwd_deterministic = torch.equal(lse, lse2) and torch.equal(tgt, tgt2)
        g_tol = 5e-4 if dtype == bf16 else 1e-4
        errs = {"lse": (lse - rlse).abs().max().item(),
                "tgt": (tgt - rtgt).abs().max().item(),
                "dx": _rel_err(dx, rdx), "dw": _rel_err(dw, rdw)}
        if dtype == bf16:
            dlog = torch.exp(x.float() @ w.float().T - rlse[:, None])
            dlog[torch.arange(n, device="cuda")[(t >= 0) & (t < v)],
                 t[(t >= 0) & (t < v)].long()] -= 1.0
            dlog *= c[:, None]
            errs["dx_unrounded_control"] = _rel_err(dlog @ w.float(), rdx)
            errs["dw_unrounded_control"] = _rel_err(dlog.T @ x.float(), rdw)
            del dlog
        oks = {"fused_xent_fwd": max(errs["lse"], errs["tgt"]) <= 1e-4
               and fwd_deterministic,
               "fused_xent_dx": errs["dx"] <= g_tol and deterministic,
               "fused_xent_dw": errs["dw"] <= g_tol and deterministic}

        t_lib = t.long()
        xl = x.detach().clone().requires_grad_(True)
        wl = w.detach().clone().requires_grad_(True)

        def lib_fwd(xl=xl, wl=wl, t_lib=t_lib, w_row=w_row, grad=False):
            logits = _library_logits(torch, xl, wl, grad)
            nll = F.cross_entropy(logits, t_lib, ignore_index=-100,
                                  reduction="none")
            return (nll * w_row).sum() / w_row.sum().clamp_min(1.0)

        def lib_fwd_bwd(xl=xl, wl=wl):
            return torch.autograd.grad(lib_fwd(grad=True), (xl, wl))

        lib_loss = lib_fwd(grad=True)

        def lib_bwd(xl=xl, wl=wl, lib_loss=lib_loss):
            return torch.autograd.grad(lib_loss, (xl, wl), retain_graph=True)

        emit({"phase": "fused_xent_check", "case": name, **errs,
              "deterministic": deterministic,
              "fwd_deterministic": fwd_deterministic, "ok": oks})
        it = dict(iters=5, reps=3)
        plain_it = dict(iters=2, reps=3)
        lib_ms = time_ms(torch, lib_fwd, [()], graph=False, **plain_it)
        lib_fwd_bwd_ms = time_ms(torch, lib_fwd_bwd, [()], graph=False,
                                 **plain_it)
        lib_bwd_ms = time_ms(torch, lib_bwd, [()], graph=False, **plain_it)
        del lib_loss, lib_bwd
        el = x.element_size()
        flops = 2.0 * n * v * d
        xb, wb, rb = n * d * el, v * d * el, 4 * n
        common = {"case": name, "n": n, "d": d, "v": v,
                  "dtype": str(dtype)[6:],
                  "library": ("mm(out_dtype=fp32)" if dtype == bf16 else "mm")
                  + " + F.cross_entropy"}
        specs = [
            ("fused_xent_fwd", fx.xent_fwd_cuda, fx.xent_fwd_plain,
             (x, w, t), flops, xb + wb + rb + 2 * rb, lib_ms,
             {"lse_max_abs_err": errs["lse"],
              "tgt_max_abs_err": errs["tgt"],
              "deterministic": fwd_deterministic,
              "tolerance": "lse, tgt atol 1e-4; bit-identical on a rerun"},
             max(errs["lse"], errs["tgt"])),
            ("fused_xent_dx", fx.xent_dx_cuda, fx.xent_dx_plain, bargs,
             2 * flops, xb + wb + 3 * rb + 4 * n * d, lib_bwd_ms,
             {"dx_rel_err": errs["dx"], "deterministic": deterministic,
              "dx_unrounded_control": errs.get("dx_unrounded_control"),
              "tolerance": f"{g_tol} of max|dx|; bit-identical on a rerun"},
             (dx - rdx).abs().max().item()),
            ("fused_xent_dw", fx.xent_dw_cuda, fx.xent_dw_plain, bargs,
             2 * flops, xb + wb + 3 * rb + 4 * v * d, lib_bwd_ms,
             {"dw_rel_err": errs["dw"], "deterministic": deterministic,
              "dw_unrounded_control": errs.get("dw_unrounded_control"),
              "tolerance": f"{g_tol} of max|dw|; bit-identical on a rerun"},
             (dw - rdw).abs().max().item()),
        ]
        for kname, kern, plain, args, kflops, nbytes, lms, extra, err \
                in specs:
            bms, by = bound_ms(nbytes, kflops, dtype)
            row = {"kernel": kname, **common, "max_abs_err": err, **extra,
                   "flops": kflops, "ms": time_ms(torch, kern, [args], **it),
                   "plain_ms": time_ms(torch, plain, [args], **plain_it),
                   "library_ms": lms, "bound_ms": bms, "bound_by": by}
            if kname == "fused_xent_fwd":
                plan = fx.xent_fwd_plan(n, v, d, dtype)
                row.update(variant=plan.variant, plan=plan._asdict(),
                           mm_ms=time_ms(torch, lambda a, b: torch.mm(a, b.t()),
                                         [(x, w)], **it),
                           mm="torch.mm(x, w.t()) in the operands' dtype: "
                              "the logits written, a yardstick")
            else:
                rows_own = n if kname == "fused_xent_dx" else v
                plan = fx.xent_bwd_plan(rows_own, n + v - rows_own, d, dtype)
                row.update(
                    variant=plan.variant, plan={
                        "k": plan.k, "m": plan.m, "s": plan.s,
                        "stages": plan.stages, "smem": plan.smem,
                        "grid": plan.grid},
                    library=("mm, widened + F.cross_entropy: backward "
                             "alone (eager, retained graph)"),
                    library_fwd_bwd_ms=lib_fwd_bwd_ms)
            emit(row)
            if not oks[kname]:
                raise AssertionError(f"{kname} kernel disagrees: {row}")
            rows[kname].append(row)
        del xl, wl, x, w, dx, dw, rdx, rdw, dx2, dw2
        torch.cuda.empty_cache()
    return rows


#: Kernel launches of one gpt_small (or gpt_moe_small) training step with
#: block remat: the LayerNorm forward 25 times in the forward and 24 again
#: when the 12 blocks are recomputed, its backward 25 times; the flash
#: forward once a layer and again in the recomputation; the single-sweep
#: backward K3f once a layer (S 2048 x D 64 x 4 bytes fits the 2 MiB
#: threshold, so the split pair does not run); the fused head's forward
#: once (it lies outside the recomputed blocks) and its dx and dw kernels
#: once each in the backward.
TRAIN_LAUNCHES_PER_STEP = {"layernorm_fwd": 49, "layernorm_bwd": 25,
                           "flash_fwd": 24, "flash_bwd_fused": 12,
                           "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                           "fused_xent_fwd": 1, "fused_xent_dx": 1,
                           "fused_xent_dw": 1}
#: lm_long_context's step: attention-only remat recomputes the attention
#: (the flash forward twice a layer) but no LayerNorm.
LONG_LAUNCHES_PER_STEP = {**TRAIN_LAUNCHES_PER_STEP, "layernorm_fwd": 25}
HEAD_KERNELS = ("fused_xent_fwd", "fused_xent_dx", "fused_xent_dw")
FLASH_ROWS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
              "flash_bwd_fused")


def _train_args(train_torch, *extra):
    """gpt_lm at its preset defaults (xent_impl "auto": the fused head on
    the card), cut to batch 8 at seq 2048."""
    return train_torch.parse_args(
        ["--workload", "gpt_lm", "--batch-size", "8", "--seq-len", "2048",
         "--remat", "on", "--seed", str(SEED), "--device", "cuda", *extra])


def _param_count(model):
    return sum(p.numel() for p in model.parameters())


def _flops_per_token(model, cfg, seq) -> tuple[float, str]:
    """MFU's flops per token, 6 N + 6 L S E (PERF.md section 2), and how
    N was counted.  In an MoE model a token runs only the experts it is
    routed to, so of the experts' parameters N counts the router's
    assignments per token over the number of experts (2 of 8 at top-2):
    6 (N - N_experts 6/8)."""
    n = _param_count(model)
    n_experts = sum(p.numel() for name, p in model.named_parameters()
                    if ".experts_" in name)
    how = "N all parameters, the tied table once"
    if n_experts:
        from distributedtensorflow_tpu_torch.parallel import moe
        active = moe._ASSIGNMENTS[cfg.router] / cfg.n_experts
        n -= n_experts * (1.0 - active)
        how = (f"N all parameters less the experts a token skips: "
               f"{n_experts} expert parameters x {1.0 - active}")
    return 6 * n + 6 * cfg.num_layers * seq * cfg.hidden_size, how


def train_steps(torch, cuda, train_torch, args, steps, phase):
    """One warm-up step and ``steps`` timed ones through
    ``train_torch.build``; launch counts set to 0 after the warm-up and
    read after the last step.  Losses must be finite and the language
    model's loss (log perplexity: the whole loss but for gpt_moe's router
    term) must end below where it began."""
    wl, state, step, batches = train_torch.build(args)
    cfg = wl.cfg
    state, m = step(state, next(batches))  # warm-up
    metrics = [m]
    losses = [float(m["loss"])]
    torch.cuda.synchronize()
    cuda.launches.clear()
    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(steps):
        batch = next(batches)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
        metrics.append(m)
    launches = dict(cuda.launches)
    lm_losses = [math.log(float(m["perplexity"])) for m in metrics]
    if not all(math.isfinite(x) for x in losses) \
            or not lm_losses[-1] < lm_losses[0]:
        raise AssertionError(f"{phase}: training losses not finite or the "
                             f"LM loss not falling: {losses}, LM "
                             f"{lm_losses}")
    tokens = wl.global_batch_size * wl.seq_len
    step_s = statistics.median(times)
    n_params = _param_count(state.model)
    flops_per_token, mfu_n = _flops_per_token(state.model, cfg, wl.seq_len)
    tps = tokens / step_s
    row = {"phase": phase, "workload": wl.name,
           "batch": wl.global_batch_size, "seq": wl.seq_len,
           "layers": cfg.num_layers, "hidden": cfg.hidden_size,
           "params": n_params, "remat": cfg.remat,
           "remat_attn": cfg.remat_attn, "attn_impl": cfg.attn_impl,
           "xent_impl": cfg.xent_impl, "losses": losses,
           "lm_losses": lm_losses,
           "aux_losses": [float(m["aux_loss"]) for m in metrics
                          if "aux_loss" in m],
           "step_ms": [1e3 * t for t in times],
           "step_ms_median": 1e3 * step_s, "tokens_per_sec": tps,
           "mfu": flops_per_token * tps / PEAK_FLOPS["bfloat16"],
           "mfu_flops_per_token": flops_per_token, "mfu_n": mfu_n,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launches,
           "launches_per_step": {k: v / steps for k, v in launches.items()}}
    return state, step, batches, launches, row


def _check_launches(phase, launches, steps, expected):
    """Each kernel of ``expected`` launched its count per step (0 = not
    at all), and decode attention did not run."""
    per_step = {k: launches.get(k, 0) / steps for k in expected}
    if per_step != expected or launches.get("decode_attention"):
        raise AssertionError(f"{phase}: launches per training step "
                             f"{per_step} (all: {launches}), expected "
                             f"{expected}")


def _split(per_step):
    """``per_step`` with the split pair in K3f's place."""
    return {**per_step, "flash_bwd_fused": 0,
            "flash_bwd_dq": per_step["flash_bwd_fused"],
            "flash_bwd_dkv": per_step["flash_bwd_fused"]}


@contextlib.contextmanager
def _backward(fa, impl):
    """``fa.BACKWARD_IMPL = impl`` inside the block, the default after."""
    fa.BACKWARD_IMPL = impl
    try:
        yield
    finally:
        fa.BACKWARD_IMPL = "pallas"


def run_train(torch, cuda, train_torch):
    """Full-width GPT-2-small steps at the preset defaults: the fused head,
    the single-sweep backward K3f and every other kernel of the step
    launch their derived counts."""
    state, step, batches, launches, row = train_steps(
        torch, cuda, train_torch, _train_args(train_torch), 4, "train")
    row["backward_impl"] = "pallas"
    emit(row)
    _check_launches("train", launches, 4, TRAIN_LAUNCHES_PER_STEP)
    return state, step, batches, launches, row


def run_train_split(torch, cuda, train_torch, fa, fused_row):
    """The same gpt_lm steps with ``BACKWARD_IMPL = "pallas_split"``: the
    split pair keeps a path (dq and dk/dv once a layer, K3f never), and
    its step time stands beside K3f's."""
    with _backward(fa, "pallas_split"):
        _, _, _, launches, row = train_steps(
            torch, cuda, train_torch, _train_args(train_torch), 4,
            "train_split")
    row["backward_impl"] = "pallas_split"
    row["k3f_step_ms_median"] = fused_row["step_ms_median"]
    emit(row)
    _check_launches("train_split", launches, 4,
                    _split(TRAIN_LAUNCHES_PER_STEP))
    return launches


def run_train_chunked(torch, cuda, train_torch):
    """The same steps with ``--xent-impl chunked``, timed beside the fused
    head for the record (not asserted beyond finite, falling losses)."""
    state, step, batches, launches, row = train_steps(
        torch, cuda, train_torch,
        _train_args(train_torch, "--xent-impl", "chunked"), 4,
        "train_chunked")
    emit(row)
    return state, step, batches


def run_train_medium(torch, cuda, train_torch):
    """gpt_medium_lm at full width (24 layers, hidden 1024) and its preset
    defaults, batch 8 at seq 2048 (cut from 64), 1 + 3 steps."""
    args = train_torch.parse_args(
        ["--workload", "gpt_medium_lm", "--batch-size", "8", "--seed",
         str(SEED), "--device", "cuda"])
    _, _, _, launches, row = train_steps(torch, cuda, train_torch, args, 3,
                                         "train_medium")
    emit(row)
    missing = [k for k in HEAD_KERNELS + ("flash_fwd", "flash_bwd_fused")
               if not launches.get(k)]
    if missing or row["hidden"] != 1024 or row["layers"] != 24 \
            or launches.get("flash_bwd_dq") or launches.get("flash_bwd_dkv"):
        raise AssertionError(f"train_medium: {missing} did not launch, the "
                             f"split pair did, or the config is cut: {row}")
    return launches


def run_train_long(torch, cuda, train_torch, fa, fused_row=None):
    """lm_long_context at full width (gpt_small) and its preset defaults
    (seq 8192, attention-only remat, flash forced, fused head), batch 2
    (cut from 64), 1 + 2 steps.  S 8192 x D 64 x 4 bytes is exactly the
    2 MiB threshold, so the backward is K3f; with ``fused_row`` (that
    run's row) the same steps run again under ``"pallas_split"`` and
    stand beside it."""
    impl = "pallas" if fused_row is None else "pallas_split"
    args = train_torch.parse_args(
        ["--workload", "lm_long_context", "--batch-size", "2", "--seed",
         str(SEED), "--device", "cuda"])
    with _backward(fa, impl):
        _, _, _, launches, row = train_steps(
            torch, cuda, train_torch, args, 2,
            "train_long" if fused_row is None else "train_long_split")
    row["backward_impl"] = impl
    if fused_row is not None:
        row["k3f_step_ms_median"] = fused_row["step_ms_median"]
    emit(row)
    if row["seq"] != 8192 or not row["remat_attn"] \
            or row["attn_impl"] != "pallas":
        raise AssertionError(f"{row['phase']}: the preset defaults did not "
                             f"apply: {row}")
    _check_launches(row["phase"], launches, 2,
                    LONG_LAUNCHES_PER_STEP if fused_row is None
                    else _split(LONG_LAUNCHES_PER_STEP))
    return launches, row


def run_train_moe(torch, cuda, train_torch):
    """gpt_moe at full width and its preset defaults (GPT-2-small, eight
    experts on every second block, top-2 routing, capacity factor 1.25,
    block remat, fused head), batch 8 (cut from 64) at seq 2048, 1 + 3
    steps: the same launches per step as gpt_lm's (the MoE blocks run the
    same LayerNorm and attention kernels; the experts are batched
    products)."""
    args = train_torch.parse_args(
        ["--workload", "gpt_moe", "--batch-size", "8", "--seed", str(SEED),
         "--device", "cuda"])
    state, step, batches, launches, row = train_steps(
        torch, cuda, train_torch, args, 3, "train_moe")
    cfg = state.model.cfg
    row.update(n_experts=cfg.n_experts, moe_every_k=cfg.moe_every_k,
               router=cfg.router, capacity_factor=cfg.capacity_factor)
    emit(row)
    if row["seq"] != 2048 or row["hidden"] != 768 or cfg.n_experts != 8:
        raise AssertionError(f"train_moe: the preset is cut: {row}")
    _check_launches("train_moe", launches, 3, TRAIN_LAUNCHES_PER_STEP)
    return state, step, batches, launches


def run_profile_train(torch, state, step, batches, phase="profile_train"):
    from torch.profiler import ProfilerActivity, profile

    batch = [next(batches) for _ in range(2)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for bt in batch:
            state, m = step(state, bt)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.time() - t0
    kernels = device_events(torch, prof)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    emit({"phase": phase, "steps": 2, "wall_ms": 1e3 * wall,
          "device_busy_ms": busy,
          "device_idle_share": 1.0 - busy / (1e3 * wall),
          "top_kernels": [{"name": e.key[:80], "calls": e.count,
                           "ms": e.self_device_time_total / 1e3}
                          for e in top]})


def _routes(torch, moe, x, router, cfg):
    """Top-2 expert choices (T, 2), slots and kept flags of the MoE block
    input ``x`` (B, S, d), as ``local_moe`` routes it, on the CPU; and
    the fp32 router probabilities."""
    x = x.detach().cpu().reshape(-1, x.shape[-1]).float()
    logits = x @ router.detach().cpu().float()
    cap = moe.capacity_for(x.shape[0], cfg.n_experts, cfg.capacity_factor,
                           cfg.router)
    expert, slot, keep, _, _ = moe.ROUTERS[cfg.router](logits, cap)
    return (expert, slot, keep), torch.softmax(logits, -1)


def run_consistency_train(torch, mods, cuda, fa, xent, backward_impl="pallas",
                          moe=False, device="cuda"):
    """fp32 loss and gradients of 2 full-width layers at S=1024, B=1, the
    flash kernels forced, the head ``xent`` ("chunked" or "fused") and
    the flash backward ``backward_impl`` (S 1024 takes K3f under
    "pallas"), on the card against the CPU's plain path.  ``moe`` runs
    gpt_moe's layers instead (1 dense block, 1 MoE block of 8 experts):
    the card's and the CPU's MoE inputs must route every token to the same
    experts and slots; the smallest top-1/top-2 and top-2/top-3 router
    probability margins are reported beside it."""
    from distributedtensorflow_tpu_torch.parallel import moe as moe_lib

    base = mods.gpt_moe_small() if moe else mods.gpt_small()
    cfg = dataclasses.replace(base, num_layers=2, dtype=torch.float32,
                              attn_impl="pallas", xent_impl=xent)
    state = mods.init_params(cfg, torch.Generator().manual_seed(SEED + 7))
    ids = np.random.default_rng(SEED + 7).integers(0, cfg.vocab_size,
                                                   (1, 1024))
    out, routes = {}, {}
    cuda.launches.clear()
    with _backward(fa, backward_impl):
        for dev in (device, "cpu"):
            model = (mods.GPTMoELM if moe else mods.GPTLM)(cfg, device=dev)
            model.load_state_dict(state)
            hook = None
            if moe:
                def record(mod, inp, res, dev=dev):
                    # the first call (block remat calls it again)
                    if dev not in routes:
                        routes[dev] = _routes(torch, moe_lib, inp[0],
                                              mod.router, cfg)

                hook = model.h[1].moe_mlp.register_forward_hook(record)
            loss_fn = (mods.moe_lm_loss if moe else mods.lm_loss)(model)
            loss, _ = loss_fn({"input_ids": torch.as_tensor(ids, device=dev)})
            names, params = zip(*model.named_parameters())
            grads = torch.autograd.grad(loss, params)
            out[dev] = (float(loss.detach()),
                        {n: gr.cpu() for n, gr in zip(names, grads)})
            if hook is not None:
                hook.remove()
    launches = dict(cuda.launches)
    (card_loss, card_g), (cpu_loss, cpu_g) = out[device], out["cpu"]
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    worst = max(((card_g[n] - cpu_g[n]).abs().max()
                 / cpu_g[n].abs().max().clamp_min(1e-30)).item()
                for n in cpu_g)
    per_step = _split(TRAIN_LAUNCHES_PER_STEP) \
        if backward_impl == "pallas_split" else TRAIN_LAUNCHES_PER_STEP
    expected = [k for k, n in per_step.items()
                if n and (xent == "fused" or k not in HEAD_KERNELS)]
    absent = [k for k, n in per_step.items() if not n]
    ok = loss_rel <= 1e-5 and worst <= 1e-3 \
        and all(launches.get(k) for k in expected) \
        and not any(launches.get(k) for k in absent)
    row = {"phase": "consistency_train", "model": cfg.__class__.__name__,
           "dtype": "float32", "layers": 2, "batch": 1, "seq": 1024,
           "attn_impl": "pallas", "xent_impl": xent,
           "backward_impl": backward_impl, "card_loss": card_loss,
           "cpu_loss": cpu_loss, "loss_rel_err": loss_rel,
           "worst_grad_rel_err": worst,
           "tolerance": "loss 1e-5 relative; every gradient leaf 1e-3 of "
                        "its max-abs", "launches": launches}
    if moe:
        (ce, cs, ck), _ = routes[device]
        (pe, ps, pk), probs = routes["cpu"]
        same = torch.equal(ce, pe) and torch.equal(cs, ps) \
            and torch.equal(ck, pk)
        top = probs.topk(3, dim=-1).values
        row.update(same_expert_assignments=same,
                   differing_tokens=int((ce != pe).any(-1).sum()),
                   kept_assignments=int(pk.sum()),
                   min_top1_top2_margin=(top[:, 0] - top[:, 1]).min().item(),
                   min_top2_top3_margin=(top[:, 1] - top[:, 2]).min().item())
        ok = ok and same
    emit(row)
    if not ok:
        raise AssertionError(
            f"card training step ({row['model']}, {xent} head, "
            f"{backward_impl}) differs from the CPU's or launched other "
            "kernels than its path")


def run_consistency_bf16(torch, mods, cuda, device="cuda", seq=2048):
    """bf16 loss and gradients of 2 full-width layers at S=2048, B=2, on
    the card: the same weights and batch once through the flash kernels
    (``attn_impl="pallas"``: K2 and K3f on the tensor cores) and once
    through the plain attention (``attn_impl="xla"``).  The losses agree
    within 1e-2 relative; the gradient leaves' worst distance is
    reported (the two paths round at different points in bf16)."""
    base = dataclasses.replace(mods.gpt_small(), num_layers=2,
                               dtype=torch.bfloat16)
    state = mods.init_params(base, torch.Generator().manual_seed(SEED + 10))
    ids = torch.as_tensor(np.random.default_rng(SEED + 10).integers(
        0, base.vocab_size, (2, seq)), device=device)
    out, launches = {}, {}
    for impl in ("pallas", "xla"):
        cfg = dataclasses.replace(base, attn_impl=impl)
        model = mods.GPTLM(cfg, device=device)
        model.load_state_dict(state)
        cuda.launches.clear()
        loss, _ = mods.lm_loss(model)({"input_ids": ids})
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params)
        sync(torch, torch.device(device))
        launches[impl] = dict(cuda.launches)
        out[impl] = (float(loss.detach()),
                     {n: gr.float() for n, gr in zip(names, grads)})
    (k_loss, k_g), (x_loss, x_g) = out["pallas"], out["xla"]
    loss_rel = abs(k_loss - x_loss) / abs(x_loss)
    worst = max(_rel_err(k_g[n], x_g[n]) for n in x_g)
    flash = ("flash_fwd", "flash_bwd_fused")
    ok = math.isfinite(k_loss) and loss_rel <= 1e-2 \
        and (device == "cpu"
             or all(launches["pallas"].get(k) for k in flash)) \
        and not any(launches["xla"].get(k) for k in flash) \
        and all(bool(torch.isfinite(gr).all()) for gr in k_g.values())
    row = {"phase": "consistency_bf16", "dtype": "bfloat16", "layers": 2,
           "batch": 2, "seq": seq, "kernels_loss": k_loss,
           "xla_loss": x_loss, "loss_rel_err": loss_rel,
           "worst_grad_rel_err": worst,
           "tolerance": "loss 1e-2 relative; gradients finite (their "
                        "distance is reported)",
           "launches": launches}
    emit(row)
    if not ok:
        raise AssertionError(f"bf16 step through the flash kernels differs "
                             f"from the plain attention's: {row}")


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def empty_cache(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()


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
    if not launches.get("layernorm_fwd"):
        raise AssertionError(f"generate ran no layernorm kernel: {launches}")
    # one K5 call a layer for each one-token forward: the first prompt
    # token's prefill and 46 decode steps (the last step's unused forward
    # is skipped)
    if launches.get("decode_attention") != model.cfg.num_layers * 47:
        raise AssertionError(f"generate launched decode attention "
                             f"{launches.get('decode_attention')} times, "
                             f"expected {model.cfg.num_layers * 47}")
    emit({"phase": "generate", "batch": 4, "prompt": 16, "new_tokens": 32,
          "wall_s": wall, "ms_per_token_step": 1e3 * wall / 47,
          "tokens_per_s": 4 * 32 / wall, "launches": launches})
    return launches


def _last_logits(torch, mods, model, tokens):
    """fp32 logits (B, V) of the last position of ``tokens`` (B, T): the
    first T - 1 through prefill chunks of 1024 (the grouped einsum path,
    whatever ``DECODE_IMPL`` says), the last as a one-token step (the path
    ``DECODE_IMPL`` names)."""
    b, t = tokens.shape
    dev = tokens.device
    cache = model.init_cache(b)
    for i in range(0, t - 1, 1024):
        chunk = tokens[:, i:min(i + 1024, t - 1)]
        pos = torch.arange(i, i + chunk.shape[1], device=dev).expand(b, -1)
        _, cache = mods.prefill(model, chunk, pos, cache=cache)
    logits, _ = mods.decode_step(
        model, tokens[:, -1:], torch.full((b, 1), t - 1, device=dev), cache)
    return logits[:, -1].float()


def run_generate_gqa(torch, cuda, mods, attn):
    """Dense ``generate`` on gpt_small at full width, cut to 4 layers,
    with one kv head (12
    query heads a group, which the first K5 refused), B 2, a 6000-token
    prompt in a cache of 8192 (past the first K5's shared-memory band),
    then 16 greedy tokens: once under ``DECODE_IMPL = "auto"`` (K5, one
    launch per layer and one-token step) and once under ``"xla"`` (the
    grouped einsum path, no K5).  The greedy tokens must be equal, and the
    next step's logits after the whole sequence agree within 1e-2 relative
    in the L2 norm (bf16: the two paths' attention outputs differ by a
    bf16 rounding here and there, which the bf16 layers carry to the
    logits; the largest single difference is reported beside it)."""
    # 6015 one-token forwards a run, each bound by the host's launches,
    # which grow with the depth: cut to keep the script's time
    cfg = dataclasses.replace(mods.gpt_small(), num_layers=4, num_kv_heads=1,
                              max_seq=8192)
    state = mods.init_params(cfg, torch.Generator().manual_seed(SEED + 12))
    model = mods.GPTLM(cfg)
    model.load_state_dict(state)
    prompt = torch.as_tensor(np.random.default_rng(SEED + 12).integers(
        0, cfg.vocab_size, (2, 6000)), device=model.device)
    new_tokens = 16
    steps = prompt.shape[1] + new_tokens - 1  # one-token forwards
    out, launches, walls, logits = {}, {}, {}, {}
    prev = attn.DECODE_IMPL
    try:
        for impl in ("auto", "xla"):
            attn.DECODE_IMPL = impl
            sync(torch, model.device)
            cuda.launches.clear()
            t0 = time.time()
            out[impl] = mods.generate(model, prompt,
                                      max_new_tokens=new_tokens)
            sync(torch, model.device)
            walls[impl] = time.time() - t0
            launches[impl] = dict(cuda.launches)
            logits[impl] = _last_logits(torch, mods, model, out[impl])
    finally:
        attn.DECODE_IMPL = prev
    same = torch.equal(out["auto"], out["xla"])
    diff = logits["auto"] - logits["xla"]
    err = (diff.norm() / logits["xla"].norm()).item()
    want = {"auto": cfg.num_layers * steps, "xla": 0}
    got = {k: launches[k].get("decode_attention", 0) for k in want}
    top2 = logits["xla"].topk(2, dim=-1).values
    row = {"phase": "generate_gqa", "batch": 2, "prompt": 6000,
           "new_tokens": new_tokens, "max_seq": cfg.max_seq,
           "layers": cfg.num_layers, "num_heads": cfg.num_heads,
           "kv_heads": cfg.kv_heads,
           "dtype": str(cfg.dtype)[6:], "same_greedy_tokens": same,
           "tokens_auto": out["auto"][:, 6000:].tolist(),
           "tokens_xla": out["xla"][:, 6000:].tolist(),
           "next_logits_rel_err": err,
           "next_logits_max_abs_err": diff.abs().max().item(),
           "next_logits_max_abs": logits["xla"].abs().max().item(),
           "next_top1_top2_margin": (top2[:, 0] - top2[:, 1]).min().item(),
           "tolerance": "greedy tokens equal; next-step logits within 1e-2 "
                        "relative (L2 norm of the difference over the "
                        "einsum path's)",
           "decode_attention_launches": got, "expected_launches": want,
           "wall_s": walls,
           "ms_per_token_step": {k: 1e3 * w / steps for k, w in walls.items()},
           "launches": launches}
    emit(row)
    if not (same and err <= 1e-2 and got == want):
        raise AssertionError(f"generate through K5 at 12 query heads a "
                             f"group differs from the einsum path: {row}")
    return launches["auto"]


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
        kernels = device_events(torch, prof)
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


#: The BASELINE.json presets at full width and their defaults: (preset,
#: batch, timed steps after one warm-up).  imagenet_resnet50's 1024 is a
#: global batch over many devices; one card takes 256.
BASELINE_RUNS = (("mnist_lenet", 128, 5), ("cifar_resnet20", 256, 5),
                 ("imagenet_resnet50", 256, 3), ("bert_mlm", 256, 2),
                 ("bert_mlm_packed", 256, 2), ("widedeep", 4096, 5))
#: Kernel launches of one BERT-base step (4 microbatches of 64 x 512):
#: 26 LayerNorms a microbatch (the embeddings', two a layer and the MLM
#: head's), each once forward and once backward; at seq 512 the attention
#: is below the flash gate (1024) and takes the plain path.
BERT_LAUNCHES_PER_STEP = {"layernorm_fwd": 104, "layernorm_bwd": 104,
                          "flash_fwd": 0, "flash_bwd_fused": 0,
                          "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                          "fused_xent_fwd": 0, "fused_xent_dx": 0,
                          "fused_xent_dw": 0}
#: The same step with the gate at 512: K2 and K3f once a layer and
#: microbatch (S 512 x D 64 x 4 bytes is under K3f's 2 MiB threshold).
BERT_GATE512_LAUNCHES_PER_STEP = {**BERT_LAUNCHES_PER_STEP,
                                  "flash_fwd": 48, "flash_bwd_fused": 48}
NO_LAUNCHES = {k: 0 for k in BERT_LAUNCHES_PER_STEP}


@contextlib.contextmanager
def _min_seq(fa, seq):
    """``fa.MIN_SEQ_FOR_PALLAS = seq`` inside the block, as before after."""
    old = fa.MIN_SEQ_FOR_PALLAS
    fa.MIN_SEQ_FOR_PALLAS = seq
    try:
        yield
    finally:
        fa.MIN_SEQ_FOR_PALLAS = old


def baseline_steps(torch, cuda, train_torch, name, batch, steps, phase,
                   device="cuda"):
    """``name`` through ``train_torch.build`` at full width and its preset
    defaults but the batch: one warm-up step, whose flops
    ``FlopCounterMode`` counts (the products and convolutions, forward
    and backward), then ``steps`` timed ones (each ends when its loss
    reaches the host), launch counts set to 0 after the warm-up.  Losses
    must be finite, every BatchNorm buffer must have moved, and the loss
    must fall: the warm-up batch's loss, recomputed after the timed steps
    with the same microbatches and dropout masks, must be below the one
    the warm-up step took.  (Across batches the loss of a few steps moves
    by the batches' spread at these presets' rates: imagenet_resnet50
    warms up from lr 0, widedeep's adagrad at 0.01 touches a row of its
    100k-row tables once in 25 batches; that comparison is printed.)"""
    from torch.utils.flop_counter import FlopCounterMode

    from distributedtensorflow_tpu_torch.train import (
        split_microbatches,
        step_generator,
    )

    args = train_torch.parse_args(
        ["--workload", name, "--batch-size", str(batch), "--seed", str(SEED),
         "--device", device])
    wl, state, step, batches = train_torch.build(args)
    model = state.model
    on_card = model.device.type == "cuda"
    buffers = {k: b.clone() for k, b in model.named_buffers()}
    first = next(batches)
    with FlopCounterMode(display=False) as counter:
        state, m = step(state, first)
    flops = counter.get_total_flops()
    losses = [float(m["loss"])]
    sync(torch, model.device)
    cuda.launches.clear()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        b = next(batches)
        t0 = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    launches = dict(cuda.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
    moved = all(not torch.equal(buffers[k], b)
                for k, b in model.named_buffers())
    loss_fn = wl.loss_fn(model)
    with torch.no_grad():
        again = sum(float(loss_fn(mb, step_generator(SEED, 0, i))[0])
                    for i, mb in enumerate(
                        split_microbatches(first, wl.accum_steps))) \
            / wl.accum_steps
    step_s = statistics.median(times)
    cfg = wl.cfg
    row = {"phase": phase, "workload": name, "batch": batch,
           "accum_steps": wl.accum_steps, "seq": wl.seq_len,
           "dtype": str(cfg.dtype).removeprefix("torch."),
           "params": _param_count(model), "bn_buffers": len(buffers),
           "losses": losses, "warmup_batch_loss_after": again,
           "last_below_first": losses[-1] < losses[0],
           "metrics": {k: float(v) for k, v in m.items()},
           "step_ms": [1e3 * t for t in times],
           "step_ms_median": 1e3 * step_s,
           "examples_per_sec": batch / step_s,
           "tokens_per_sec": batch * wl.seq_len / step_s
           if wl.seq_len else None,
           "flops_per_step": flops,
           "flops_counted_by": "torch.utils.flop_counter.FlopCounterMode "
                               "over the warm-up step",
           "mfu": flops / step_s / PEAK_FLOPS["bfloat16"],
           "peak_mem_gib": peak, "launches": launches,
           "launches_per_step": {k: v / steps for k, v in launches.items()}}
    if not all(math.isfinite(x) for x in losses + [again]) \
            or not again < losses[0] or (buffers and not moved):
        raise AssertionError(f"{phase}: losses not finite or not falling, "
                             f"or the BatchNorm buffers did not move: {row}")
    return state, step, batches, launches, row


def run_baseline(torch, cuda, train_torch, fa, device="cuda"):
    """Every BASELINE preset at full width (``BASELINE_RUNS``); a
    torch.profiler window over two steps of imagenet_resnet50 and of
    bert_mlm; then bert_mlm_packed again with ``MIN_SEQ_FOR_PALLAS`` at
    512, which sends its attention (non-causal, segment ids, D 64) to K2
    and K3f: its warm-up loss within 1e-2 of the default run's (the same
    weights, batch and dropout masks; bf16), both step times printed.
    Returns the launches of the runs."""
    launches = collections.Counter()
    rows = {}
    for name, batch, steps in BASELINE_RUNS:
        state, step, batches, got, row = baseline_steps(
            torch, cuda, train_torch, name, batch, steps, "baseline", device)
        emit(row)
        if device == "cuda":
            _check_launches(f"baseline {name}", got, steps,
                            BERT_LAUNCHES_PER_STEP if name.startswith("bert")
                            else NO_LAUNCHES)
        launches.update(got)
        rows[name] = row
        if name in ("imagenet_resnet50", "bert_mlm") and device == "cuda":
            run_profile_train(torch, state, step, batches,
                              f"profile_{name}")
        del state, step, batches
        if device == "cuda":
            torch.cuda.empty_cache()
    name, batch, steps = next(r for r in BASELINE_RUNS
                              if r[0] == "bert_mlm_packed")
    with _min_seq(fa, 512):
        _, _, _, got, row = baseline_steps(
            torch, cuda, train_torch, name, batch, steps,
            "baseline_gate512", device)
    ref = rows["bert_mlm_packed"]
    rel = abs(row["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    # FlopCounterMode does not see the custom K2/K3f ops, so this run's
    # count lacks the attention's products: its MFU takes the default
    # run's count of the same work
    flops = ref["flops_per_step"]
    row.update(min_seq_for_pallas=512, default_losses=ref["losses"],
               warmup_loss_rel_err=rel,
               default_step_ms_median=ref["step_ms_median"],
               flops_counted_without_flash=row["flops_per_step"],
               flops_per_step=flops,
               flops_counted_by="the default run's FlopCounterMode count "
                                "(the same work; the custom K2/K3f ops "
                                "are invisible to the counter)",
               mfu=flops / (row["step_ms_median"] / 1e3)
               / PEAK_FLOPS["bfloat16"],
               tolerance="warm-up loss 1e-2 relative of the default run's "
                         "(a coarse record: K2 and K3f are held against "
                         "their plain twins at these shapes in "
                         "check_flash, case bert_packed)")
    emit(row)
    if device == "cuda":
        _check_launches("baseline_gate512", got, steps,
                        BERT_GATE512_LAUNCHES_PER_STEP)
    if rel > 1e-2:
        raise AssertionError(f"bert_mlm_packed through the flash kernels "
                             f"differs from the plain attention: {row}")
    launches.update(got)
    return launches


def run_consistency_baseline(torch, mods, train, cuda, family,
                             device="cuda"):
    """fp32 loss, gradients and BatchNorm running statistics of one step's
    forward and backward on the card against the port's CPU path from the
    same weights and batch: ``family`` "resnet" is ImageNetResNet at
    stage sizes (1, 1, 1, 1), 64x64, batch 8, the preset's loss with its
    L2 term (every BatchNorm scale at 1, so no residual branch starts at
    0; cuDNN's TF32 off); "bert" is BERT-base cut to 2 layers, batch 2 at
    seq 512, dropout 0, the gathered head, with K1f and K1b on the card.
    (Scales drawn in [0.9, 1.1] instead leave this ResNet's fp32
    gradients on the CPU 6.5e-2 of a leaf's max from an fp64 evaluation,
    against 7.6e-6 at 1.)  The attention's key biases get no gradient (a
    key bias shifts a query's scores by one constant): their values are
    rounding, held below 1e-6 of the largest gradient."""
    rng = np.random.default_rng(SEED + 11)
    if family == "resnet":
        cfg = mods.ImageNetResNetConfig(stage_sizes=(1, 1, 1, 1),
                                        dtype=torch.float32)
        state = mods.init_params(cfg, torch.Generator().manual_seed(SEED))
        for k, v in state.items():
            if k.endswith(".scale"):
                state[k] = torch.ones_like(v)
        batch = {"image": rng.standard_normal((8, 64, 64, 3)).astype(
                     np.float32),
                 "label": rng.integers(0, 1000, 8)}

        def loss_of(model):
            return train.classification_loss(model, weight_decay=1e-4)
    else:
        cfg = dataclasses.replace(mods.bert_base(), num_layers=2,
                                  dtype=torch.float32, dropout_rate=0.0)
        state = mods.init_params(cfg, torch.Generator().manual_seed(SEED))
        ids = rng.integers(4, cfg.vocab_size, (2, 512))
        masked = rng.random((2, 512)) < 0.15
        batch = {"input_ids": np.where(masked, 3, ids),
                 "labels": np.where(masked, ids, -100),
                 "attention_mask": np.ones((2, 512), np.int64)}

        def loss_of(model):
            return mods.mlm_loss(model,
                                 max_predictions=mods.max_predictions_for(512))
    out = {}
    cuda.launches.clear()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for dev in (device, "cpu"):
            model = mods.convert.MODELS[type(cfg)](cfg, device=dev)
            model.load_state_dict(state)
            loss, _ = loss_of(model)({k: torch.as_tensor(v, device=dev)
                                      for k, v in batch.items()})
            names, params = zip(*model.named_parameters())
            grads = torch.autograd.grad(loss, params)
            out[dev] = (float(loss.detach()),
                        {n: gr.cpu() for n, gr in zip(names, grads)},
                        {n: b.cpu() for n, b in model.named_buffers()})
    launches = dict(cuda.launches)
    (card_loss, card_g, card_b), (cpu_loss, cpu_g, cpu_b) = \
        out[device], out["cpu"]

    def worst(got, ref):
        return max(((got[n] - ref[n]).abs().max()
                    / ref[n].abs().max().clamp_min(1e-30)).item()
                   for n in ref) if ref else 0.0

    zero = [n for n in cpu_g if n.endswith(".key.bias")]
    top = max(g.abs().max().item() for g in cpu_g.values())
    zero_err = max([max(card_g[n].abs().max().item(),
                        cpu_g[n].abs().max().item()) / top for n in zero],
                   default=0.0)
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    grad_err = worst(card_g, {n: g for n, g in cpu_g.items()
                              if n not in zero})
    stats_err = worst(card_b, cpu_b)
    ln_ok = family == "resnet" or device == "cpu" or (
        launches.get("layernorm_fwd") == 6 and
        launches.get("layernorm_bwd") == 6)
    ok = loss_rel <= 1e-5 and grad_err <= 1e-3 and stats_err <= 1e-5 \
        and zero_err <= 1e-6 and ln_ok
    row = {"phase": "consistency_baseline",
           "model": mods.convert.MODELS[type(cfg)].__name__,
           "dtype": "float32", "card_loss": card_loss, "cpu_loss": cpu_loss,
           "loss_rel_err": loss_rel, "worst_grad_rel_err": grad_err,
           "worst_running_stat_rel_err": stats_err,
           "key_bias_grad_over_largest": zero_err,
           "tolerance": "loss 1e-5 relative; every gradient leaf 1e-3 of "
                        "its max-abs (key biases below 1e-6 of the largest "
                        "gradient); running statistics 1e-5 of their "
                        "max-abs; BERT: K1f and K1b 6 launches each",
           "launches": launches}
    emit(row)
    if not ok:
        raise AssertionError(f"card step of {row['model']} differs from the "
                             f"CPU's: {row}")


#: The two-rank check on the one card: (preset, global batch, dtype),
#: cut to DP_LAYERS layers (ResNet-20 whole), DP_STEPS steps.
#: bert_mlm_packed runs its four microbatches with the flash gate at 512;
#: cifar_resnet20 also in its preset's bf16 (the card's global BatchNorm
#: on bf16 activations).
DP_RUNS = (("gpt_lm", 8, "float32"), ("bert_mlm_packed", 32, "float32"),
           ("cifar_resnet20", 256, "float32"),
           ("cifar_resnet20", 256, "bfloat16"), ("gpt_moe", 8, "float32"))
DP_LAYERS = 2
DP_STEPS = 3
#: Relative tolerance against one process, by dtype: in bf16 each rank
#: rounds the activations and gradients of its own rows.
DP_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _dp_launches(name):
    """Launches per step and rank of a DP_RUNS preset at DP_LAYERS
    layers.  GPT (block remat): LayerNorm forward twice a LayerNorm and
    once for ln_f, backward once each, the flash forward twice a layer,
    K3f once, the head once each; BERT (4 microbatches, no remat): 2L + 2
    LayerNorms a microbatch once each way, K2 and K3f once a layer."""
    n = DP_LAYERS
    if name in ("gpt_lm", "gpt_moe"):
        return {**NO_LAUNCHES, "layernorm_fwd": 4 * n + 1,
                "layernorm_bwd": 2 * n + 1, "flash_fwd": 2 * n,
                "flash_bwd_fused": n, "fused_xent_fwd": 1,
                "fused_xent_dx": 1, "fused_xent_dw": 1}
    if name == "bert_mlm_packed":
        return {**NO_LAUNCHES, "layernorm_fwd": 4 * (2 * n + 2),
                "layernorm_bwd": 4 * (2 * n + 2), "flash_fwd": 4 * n,
                "flash_bwd_fused": 4 * n}
    return NO_LAUNCHES


@contextlib.contextmanager
def _cut_config(train_torch, **fields):
    """``train_torch.build`` of every preset whose config has ``fields``
    with them replaced (the rest as it is), inside the block."""
    make = train_torch.get_workload

    def cut(*args, **kw):
        wl = make(*args, **kw)
        if all(hasattr(wl.cfg, f) for f in fields):
            wl = dataclasses.replace(wl, cfg=dataclasses.replace(wl.cfg,
                                                                 **fields))
        return wl

    train_torch.get_workload = cut
    try:
        yield
    finally:
        train_torch.get_workload = make


@contextlib.contextmanager
def _dp_preset(train_torch, fa, name):
    """``train_torch.build`` of ``name`` cut to DP_LAYERS layers at
    dropout 0 (a rank draws the masks of its own rows, one process those
    of all rows: they cannot match), with the flash gate at 512 for
    bert_mlm_packed, inside the block."""
    with _cut_config(train_torch, num_layers=DP_LAYERS, dropout_rate=0.0), \
            _min_seq(fa, 512 if name == "bert_mlm_packed"
                     else fa.MIN_SEQ_FOR_PALLAS):
        yield


def _dp_args(train_torch, name, batch, dtype, *extra):
    return train_torch.parse_args(
        ["--workload", name, "--batch-size", str(batch), "--dtype", dtype,
         "--seed", str(SEED), "--device", "cuda", *extra])


def _dp_steps(torch, state, step, batches, cudnn=True):
    """DP_STEPS steps: the losses, the metrics and the buffers after.
    cuDNN's TF32 off: fp32 convolutions in TF32 round by the algorithm
    cuDNN picks for the batch, which differs between a rank's half batch
    and the whole one.  ``cudnn=False``: PyTorch's own convolution and
    batch-norm kernels instead of cuDNN's."""
    metrics = []
    with torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False):
        for _ in range(DP_STEPS):
            state, m = step(state, next(batches))
            metrics.append({k: float(v) for k, v in m.items()})
    return {"losses": [m["loss"] for m in metrics], "metrics": metrics,
            "buffers": {k: v.detach().cpu()
                        for k, v in state.model.named_buffers()}}


def dp_worker(out_dir) -> int:
    """One rank of the two-rank check (``--dp-worker``): the cluster from
    torchrun's variables, the gloo group, every DP_RUNS preset through
    ``train_torch.build`` with ``--mesh data=2``; its results and kernel
    launches saved as ``<out_dir>/rank<r>.pt``."""
    import torch

    import train_torch
    from distributedtensorflow_tpu_torch.ops import _cuda
    from distributedtensorflow_tpu_torch.ops import flash_attention as fa
    from distributedtensorflow_tpu_torch.parallel import bootstrap

    results = {}
    for name, batch, dtype in DP_RUNS:
        with _dp_preset(train_torch, fa, name):
            _, state, step, batches = train_torch.build(_dp_args(
                train_torch, name, batch, dtype, "--mesh", "data=2",
                "--dist-backend", "gloo"))
            _cuda.launches.clear()
            results[name, dtype] = _dp_steps(torch, state, step, batches)
        torch.cuda.synchronize()
        results[name, dtype]["launches"] = dict(_cuda.launches)
        del state, step, batches
        torch.cuda.empty_cache()
    torch.save(results, f"{out_dir}/rank{bootstrap.process_index()}.pt")
    bootstrap.shutdown()
    return 0


def _dp_reference(torch, train_torch, fa, name, batch, dtype, cudnn=True):
    """The one-process step of ``name`` on the two ranks' global batch
    (both ranks' input pipelines, rank-major)."""
    from distributedtensorflow_tpu_torch.data import (
        InputContext,
        device_put_batch,
    )

    with _dp_preset(train_torch, fa, name):
        wl, state, step, _ = train_torch.build(_dp_args(train_torch, name,
                                                        batch, dtype))
        srcs = [wl.input_fn(InputContext(2, r, batch), SEED)
                for r in range(2)]

        def global_batches():
            while True:
                parts = [next(src) for src in srcs]
                yield device_put_batch(
                    {k: np.concatenate([q[k] for q in parts])
                     for k in parts[0]}, state.model.device)

        return _dp_steps(torch, state, step, global_batches(), cudnn)


def _dp_errors(torch, got, ref):
    """The largest relative loss difference and the largest buffer
    difference over the buffer's max-abs, ``got`` against ``ref``."""
    loss = max(abs(a - b) / abs(b)
               for a, b in zip(got["losses"], ref["losses"]))
    buf = max([float((got["buffers"][k] - v).abs().max()
                     / v.abs().max().clamp_min(1e-30))
               for k, v in ref["buffers"].items()], default=0.0)
    return loss, buf


def run_dp(torch, cuda, train_torch, fa, train_row):
    """The data-parallel step.  world1: gpt_lm as the train phase runs it,
    through ``--mesh data=1`` over NCCL (bootstrap, mesh, the packed
    all-reduce): its losses equal the train phase's bit for bit; its step
    time stands beside the plain step's, and the packed all-reduce of its
    gradients is timed and profiled on its own.  gloo2: two ranks on the
    one card (NCCL refuses two ranks on one device), each a process of
    its own (``--dp-worker``: two ranks as threads of one process would
    share the card's one autograd thread, and BatchNorm's collective in
    the backward would wait there for its peer forever), against the
    one-process step on the same global batch."""
    from distributedtensorflow_tpu_torch.parallel import bootstrap
    from distributedtensorflow_tpu_torch.parallel import collectives
    from distributedtensorflow_tpu_torch.parallel.mesh import (
        MeshSpec,
        build_mesh,
    )

    if train_row is None:  # the train phase did not run: its steps here
        train_row = train_steps(torch, cuda, train_torch,
                                _train_args(train_torch), 4, "dp_plain")[-1]
        torch.cuda.empty_cache()
    state, _, _, launches, row = train_steps(
        torch, cuda, train_torch, _train_args(
            train_torch, "--mesh", "data=1", "--dist-backend", "nccl"),
        4, "dp_world1")
    grads = [torch.randn_like(p) for p in state.model.parameters()]
    mesh = build_mesh(MeshSpec(data=1))
    opts = collectives.Options(collectives.DEFAULT_BYTES_PER_PACK)

    def reduce():
        collectives.packed_all_reduce(grads, mesh, options=opts)

    by_kernel = device_ms_by_kernel(torch, reduce, (), iters=5)
    row.update({
        "backend": torch.distributed.get_backend(), "world": 1,
        "plain_losses": train_row["losses"],
        "plain_step_ms_median": train_row["step_ms_median"],
        "wrapper_ms": row["step_ms_median"] - train_row["step_ms_median"],
        "allreduce_bytes": 4 * sum(g.numel() for g in grads),
        "allreduce_packs": len(collectives.pack_by_size(
            grads, opts.bytes_per_pack)),
        "allreduce_ms": time_ms(torch, reduce, [()], iters=5, reps=3,
                                graph=False),
        "allreduce_device_ms": sum(by_kernel.values()),
        "allreduce_kernels": {k[:60]: v for k, v in by_kernel.items()}})
    emit(row)
    del state, grads
    bootstrap.shutdown()
    torch.cuda.empty_cache()
    _check_launches("dp_world1", launches, 4, TRAIN_LAUNCHES_PER_STEP)
    if row["losses"] != train_row["losses"]:
        raise AssertionError(f"dp_world1: losses {row['losses']} differ "
                             f"from the plain step's {train_row['losses']}")

    out_dir = "build/dp_check"
    import os
    os.makedirs(out_dir, exist_ok=True)
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(bootstrap.free_port()), "WORLD_SIZE": "2",
           "LOCAL_RANK": "0"}  # both ranks on the one card
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, __file__, "--dp-worker",
                               out_dir], env={**env, "RANK": str(r)})
             for r in range(2)]
    try:
        refs = {(name, dtype): _dp_reference(torch, train_torch, fa, name,
                                             batch, dtype)
                for name, batch, dtype in DP_RUNS}
        # the fp32 ResNet steps on PyTorch's kernels in place of cuDNN's:
        # how far two exact fp32 runs of one step drift apart
        key = ("cifar_resnet20", "float32")
        noise = {key: _dp_errors(torch, _dp_reference(
            torch, train_torch, fa, "cifar_resnet20", 256, "float32", cudnn=False),
            refs[key])}
        torch.cuda.empty_cache()
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if rcs != [0, 0]:
        raise AssertionError(f"dp_gloo2: the ranks exited with {rcs}")
    ranks = [torch.load(f"{out_dir}/rank{r}.pt") for r in range(2)]
    failures, total = [], collections.Counter(launches)
    for name, _, dtype in DP_RUNS:
        ref, got = refs[name, dtype], [rk[name, dtype] for rk in ranks]
        errs = [_dp_errors(torch, g, ref) for g in got]
        loss_err = max(e[0] for e in errs)
        buf_err = max(e[1] for e in errs)
        same = all(torch.equal(got[0]["buffers"][k], got[1]["buffers"][k])
                   for k in ref["buffers"])
        expected = _dp_launches(name)
        per_step = [{k: g["launches"].get(k, 0) / DP_STEPS
                     for k in expected} for g in got]
        ok = (loss_err <= DP_RTOL[dtype] and buf_err <= DP_RTOL[dtype]
              and same
              and per_step == [expected, expected]
              and not any(g["launches"].get("decode_attention")
                          for g in got))
        for g in got:
            total.update(g["launches"])
        emit({"phase": "dp_gloo2", "workload": name, "world": 2,
              "backend": "gloo", "dtype": dtype, "layers": DP_LAYERS,
              "losses": got[0]["losses"], "ref_losses": ref["losses"],
              "loss_rel_err": loss_err, "buffers": len(ref["buffers"]),
              "buffer_err": buf_err, "buffers_equal_across_ranks": same,
              "ref_noise_loss_buffer": noise.get((name, dtype)),
              "launches_per_step": per_step[0], "ok": ok,
              "tolerance": f"losses {DP_RTOL[dtype]} relative to the "
                           "one-process step on the same global batch; "
                           f"BatchNorm buffers {DP_RTOL[dtype]} of each "
                           "one's max-abs; launches per step and rank as "
                           "derived"})
        if not ok:
            failures.append((name, dtype))
    emit({"phase": "dp_gloo2_seconds", "seconds": time.time() - t0})
    if failures:
        raise AssertionError(f"dp_gloo2: {failures} differ from the "
                             "one-process step")
    return total


#: The ckpt phase: steps before the save and after the restore; the
#: SIGTERM child's depth and length.
CKPT_STEPS = 3
CKPT_OVERLAP_STEPS = 8
CKPT_CHILD_LAYERS = 2
CKPT_CHILD_STEPS = 8
#: Batches of the determinism survey's presets (2 layers where the model
#: has layers): enough rows for every kernel of the full-width path.
DET_RUNS = (("gpt_lm", 2), ("gpt_medium_lm", 2), ("lm_long_context", 1),
            ("gpt_moe", 2), ("mnist_lenet", 128), ("cifar_resnet20", 256),
            ("imagenet_resnet50", 32), ("bert_mlm", 16),
            ("bert_mlm_packed", 16), ("widedeep", 4096))


def ckpt_worker(argv_json) -> int:
    """The ckpt phase's child (``--ckpt-worker``): ``train_torch.main`` of
    the given arguments with gpt_lm cut to CKPT_CHILD_LAYERS layers, its
    log lines on stderr as ``train_torch.py`` prints them."""
    import logging

    import train_torch

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    with _cut_config(train_torch, num_layers=CKPT_CHILD_LAYERS):
        train_torch.main(json.loads(argv_json))
    return 0


def det_worker(out_path) -> int:
    """The determinism survey (``--det-worker``): two steps of every
    preset through ``train_torch.main --deterministic`` (a fresh process:
    cuBLAS reads its workspace setting when it starts).  An op without a
    deterministic CUDA version raises; its message is recorded for the
    preset and the survey goes on.  Any other failure fails the run."""
    import train_torch

    results = {}
    for name, batch in DET_RUNS:
        argv = ["--workload", name, "--batch-size", str(batch), "--steps",
                "2", "--log-every", "1", "--seed", str(SEED),
                "--deterministic", "--device", "cuda"]
        try:
            with _cut_config(train_torch, num_layers=2):
                recs = train_torch.main(argv)
            results[name] = {"ok": True, "losses": [r["loss"] for r in recs]}
        except RuntimeError as e:
            if "deterministic" not in str(e):
                raise
            results[name] = {"ok": False, "error": str(e)[:400]}
    with open(out_path, "w") as f:
        json.dump(results, f)
    return 0


def _fingerprint(state):
    from distributedtensorflow_tpu_torch.utils import tree_fingerprint

    return tree_fingerprint({"model": state.model.state_dict(),
                             "optimizer": state.optimizer.state_dict(),
                             "step": state.step})


def _timed_step(torch, step, state, batch):
    t0 = time.perf_counter()
    state, m = step(state, batch)
    loss = float(m["loss"])
    return state, loss, 1e3 * (time.perf_counter() - t0)


def _ckpt_args(train_torch, device):
    """The train phase's gpt_lm arguments; on the CPU (a rehearsal) at
    test size."""
    if device == "cuda":
        return _train_args(train_torch)
    return train_torch.parse_args(["--workload", "gpt_lm", "--test-size",
                                   "--seed", str(SEED), "--device", device])


def _ckpt_run_u(torch, train_torch, device):
    """U: gpt_lm as the train phase builds it, 2 x CKPT_STEPS steps
    uninterrupted: the losses, the fingerprint after, the step times."""
    _, state, step, batches = train_torch.build(_ckpt_args(train_torch,
                                                           device))
    losses, ms = [], []
    for _ in range(2 * CKPT_STEPS):
        state, loss, t = _timed_step(torch, step, state, next(batches))
        losses.append(loss)
        ms.append(t)
    fp = _fingerprint(state)
    return losses, fp, ms


def _child(argv, err):
    """A ckpt worker of ``argv``, its stdout piped, its stderr to the
    file ``err``."""
    return subprocess.Popen(
        [sys.executable, __file__, "--ckpt-worker", json.dumps(argv)],
        stdout=subprocess.PIPE, stderr=err, text=True)


def _child_steps(out):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def _read(path) -> str:
    with open(path) as f:
        return f.read()


def run_ckpt_sigterm(ckdir, device="cuda"):
    """(b) A child trains gpt_lm (full width, CKPT_CHILD_LAYERS layers) to
    step CKPT_CHILD_STEPS with a checkpoint directory; after its third
    step line it gets SIGTERM, saves at the next step boundary and exits
    0.  The same command relaunched restores, fast-forwards and ends at
    the last step, with the last loss of an uninterrupted child."""
    import os
    import signal

    from distributedtensorflow_tpu_torch.checkpoint import CheckpointManager

    def argv(d):
        size = ["--batch-size", "8", "--seq-len", "2048"] \
            if device == "cuda" else ["--test-size"]
        return ["--workload", "gpt_lm", *size, "--steps",
                str(CKPT_CHILD_STEPS), "--log-every", "1", "--seed",
                str(SEED), "--device", device, "--checkpoint-dir", d]

    cut = os.path.join(ckdir, "sigterm")
    logs = [os.path.join(ckdir, f"child{i}.log") for i in range(3)]
    procs = []
    t0 = time.time()
    with contextlib.ExitStack() as stack:
        files = [stack.enter_context(open(path, "w")) for path in logs]
        try:
            child = _child(argv(cut), files[0])
            procs.append(child)
            seen = []
            for line in child.stdout:
                if line.startswith("{"):
                    seen.append(json.loads(line))
                if len(seen) == 3:
                    child.send_signal(signal.SIGTERM)
                    break
            rest, _ = child.communicate(timeout=300)
            first = seen + _child_steps(rest)
            saved = CheckpointManager(cut).all_steps()
            again = _child(argv(cut), files[1])
            whole = _child(argv(os.path.join(ckdir, "whole")), files[2])
            procs += [again, whole]
            out2, _ = again.communicate(timeout=300)
            out3, _ = whole.communicate(timeout=300)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    err, err2, err3 = (_read(path) for path in logs)
    rc_first = child.returncode
    second, ref = _child_steps(out2), _child_steps(out3)
    stop = first[-1]["step"] if first else None
    ok = (rc_first == 0 and again.returncode == 0 and whole.returncode == 0
          and stop is not None and 3 <= stop < CKPT_CHILD_STEPS
          and saved and saved[-1] == stop
          and "preemption save complete" in err
          and f"restored checkpoint step {stop}" in err2
          and f"fast-forwarding input {stop} batches" in err2
          and [r["step"] for r in second]
          == list(range(stop + 1, CKPT_CHILD_STEPS + 1))
          and second[-1]["loss"] == ref[-1]["loss"])
    row = {"phase": "ckpt_sigterm", "layers": CKPT_CHILD_LAYERS,
           "steps": CKPT_CHILD_STEPS, "rc": [rc_first, again.returncode,
                                            whole.returncode],
           "stopped_at": stop, "saved_steps": saved,
           "resumed_steps": [r["step"] for r in second],
           "last_loss": second[-1]["loss"] if second else None,
           "uninterrupted_last_loss": ref[-1]["loss"] if ref else None,
           "seconds": time.time() - t0, "ok": bool(ok)}
    emit(row)
    if not ok:
        raise AssertionError(
            f"ckpt_sigterm: {row}\n--- first stderr\n{err[-3000:]}\n--- "
            f"relaunch stderr\n{err2[-3000:]}\n--- uninterrupted stderr\n"
            f"{err3[-2000:]}")


def run_ckpt(torch, cuda, train_torch, smi, device="cuda"):
    """The checkpoint plane on gpt_lm at full width.  (a) U, the
    uninterrupted run, twice; R: CKPT_STEPS steps, an async save, a fresh
    build whose weights come from another seed, ``restore_latest``,
    ``skip_batches`` and CKPT_STEPS more steps: R's losses and final
    fingerprint equal U's bit for bit, and the resumed steps launch the
    train phase's kernels their derived counts.  (b) SIGTERM and restart
    (:func:`run_ckpt_sigterm`).  (c) A flipped byte in the newest step is
    rejected and the step before restored; a directory without its commit
    marker is not a step.  (d) The checkpoint's bytes, the blocking ms of
    an async and a sync save, the background commit, the restore, the
    fast-forward, and a step that overlaps a commit beside one that does
    not (then CKPT_OVERLAP_STEPS of each).  Then the determinism survey (:func:`det_worker`).  ``device``
    "cpu" rehearses it at test size (no survey, no memory profile)."""
    import os
    import shutil
    import tempfile

    from distributedtensorflow_tpu_torch.checkpoint import CheckpointManager
    from distributedtensorflow_tpu_torch.data import (
        InputContext,
        device_put_batch,
        skip_batches,
    )
    from distributedtensorflow_tpu_torch.checkpoint import manager as cm
    from distributedtensorflow_tpu_torch.utils import (
        save_device_memory_profile,
    )
    from distributedtensorflow_tpu_torch.utils.determinism import flatten

    ckdir = tempfile.mkdtemp(prefix="dtf_ckpt_")
    try:
        # (a) U twice
        dev = torch.device(device)
        args = _ckpt_args(train_torch, device)
        u1, fp1, u_ms = _ckpt_run_u(torch, train_torch, device)
        u2, fp2, _ = _ckpt_run_u(torch, train_torch, device)
        empty_cache(torch, dev)
        emit({"phase": "ckpt_u", "losses": u1, "rerun_losses": u2,
              "rerun_bit_identical": u1 == u2 and fp1 == fp2,
              "fingerprint": fp1, "step_ms": u_ms})
        if u1 != u2 or fp1 != fp2:
            raise AssertionError(f"ckpt: the uninterrupted run does not "
                                 f"repeat on the card: {u1} vs {u2}")

        # R: steps 1-3, an async save of step 3, step 4 during its commit
        wl, state, step, batches = train_torch.build(args)
        for _ in range(CKPT_STEPS):
            state, _, _ = _timed_step(torch, step, state, next(batches))
        saved_fp = _fingerprint(state)
        mgr = CheckpointManager(os.path.join(ckdir, "a"))
        t0 = time.perf_counter()
        mgr.save(state.step, state)  # the first: allocates its host buffers
        first_ms = 1e3 * (time.perf_counter() - t0)
        state, overlap_loss, overlap_ms = _timed_step(torch, step, state,
                                                      next(batches))
        t1 = time.perf_counter()
        mgr.wait()
        first_commit_s = time.perf_counter() - t0 - first_ms / 1e3
        wait_after_step_s = time.perf_counter() - t1
        state, alone_loss, alone_ms = _timed_step(torch, step, state,
                                                  next(batches))
        # step 5, async again (the buffers reused), its commit alone
        t0 = time.perf_counter()
        mgr.save(state.step, state)
        async_ms = 1e3 * (time.perf_counter() - t0)
        t1 = time.perf_counter()
        mgr.wait()
        commit_s = time.perf_counter() - t1
        payload = os.path.join(ckdir, "a", str(CKPT_STEPS), cm.PAYLOAD)
        nbytes = os.path.getsize(payload)
        tensor_bytes = sum(
            t.numel() * t.element_size() for t in flatten(
                cm.as_tree(state)).values() if isinstance(t, torch.Tensor))
        # sync saves of the same state, timed whole: the first allocates
        # its host buffers, the second reuses them (throwaway labels)
        sync_mgr = CheckpointManager(os.path.join(ckdir, "s"), max_to_keep=1,
                                     async_save=False)
        sync_ms = []
        for label in (1, 2):
            t0 = time.perf_counter()
            sync_mgr.save(label, state)
            sync_ms.append(1e3 * (time.perf_counter() - t0))
        del sync_mgr
        shutil.rmtree(os.path.join(ckdir, "s"))
        # CKPT_OVERLAP_STEPS steps alone, then as many while an async
        # save of the state commits (a throwaway directory)
        apart_ms, beside_ms = [], []
        for times in (apart_ms, beside_ms):
            if times is beside_ms:
                omgr = CheckpointManager(os.path.join(ckdir, "o"))
                omgr.save(state.step, state)
            for _ in range(CKPT_OVERLAP_STEPS):
                state, _, t = _timed_step(torch, step, state, next(batches))
                times.append(t)
        t1 = time.perf_counter()
        omgr.wait()
        beside_left_s = time.perf_counter() - t1
        del omgr
        shutil.rmtree(os.path.join(ckdir, "o"))
        del state, step, batches
        empty_cache(torch, dev)

        # R resumed: a fresh build, weights from another seed, restore
        _, fresh, step, _ = train_torch.build(args)
        fresh.model.load_state_dict(wl.init_params(
            wl.cfg, torch.Generator().manual_seed(SEED + 1)))
        sync(torch, dev)
        t0 = time.perf_counter()
        restored = mgr.restore(CKPT_STEPS, fresh)
        sync(torch, dev)
        restore_s = time.perf_counter() - t0
        restored_ok = restored.step == CKPT_STEPS and \
            _fingerprint(fresh) == saved_fp
        t0 = time.perf_counter()
        source = skip_batches(wl.input_fn(InputContext(
            global_batch_size=wl.global_batch_size), SEED), CKPT_STEPS)
        skip_ms = 1e3 * (time.perf_counter() - t0)
        sync(torch, dev)
        cuda.launches.clear()
        r_losses = []
        for _ in range(CKPT_STEPS):
            fresh, loss, _ = _timed_step(torch, step, fresh, device_put_batch(
                next(source), fresh.model.device))
            r_losses.append(loss)
        sync(torch, dev)
        launches = dict(cuda.launches)
        r_fp = _fingerprint(fresh)
        del fresh, step
        empty_cache(torch, dev)
        exact = r_losses == u1[CKPT_STEPS:] and r_fp == fp1
        emit({"phase": "ckpt_resume", "losses": r_losses,
              "u_losses": u1[CKPT_STEPS:], "restored_equal_saved": restored_ok,
              "bit_identical": exact, "overlap_step_loss": overlap_loss,
              "u_loss_4": u1[CKPT_STEPS], "launches": launches,
              "launches_per_step": {k: v / CKPT_STEPS
                                    for k, v in launches.items()}})
        if not restored_ok or not exact or overlap_loss != u1[CKPT_STEPS] \
                or alone_loss != u1[CKPT_STEPS + 1]:
            raise AssertionError(
                f"ckpt: the resumed run differs from the uninterrupted one: "
                f"restored {restored_ok}, losses {r_losses} vs "
                f"{u1[CKPT_STEPS:]}, steps around the save {overlap_loss}, "
                f"{alone_loss} vs {u1[CKPT_STEPS:CKPT_STEPS + 2]}")
        _check_launches("ckpt_resume", launches, CKPT_STEPS,
                        TRAIN_LAUNCHES_PER_STEP)

        # (c) a flipped byte in the newest step (5); a step without marker
        newest = os.path.join(ckdir, "a", str(CKPT_STEPS + 2), cm.PAYLOAD)
        with open(newest, "r+b") as f:
            f.seek(os.path.getsize(newest) // 2)
            b = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([b[0] ^ 0xFF]))
        os.makedirs(os.path.join(ckdir, "a", "99"))
        shutil.copy(payload, os.path.join(ckdir, "a", "99"))
        _, target, _, _ = train_torch.build(args)
        t0 = time.perf_counter()
        got = mgr.restore_latest(target)
        fallback_s = time.perf_counter() - t0
        report = mgr.last_restore_report
        corrupt_ok = (got is not None and target.step == CKPT_STEPS
                      and _fingerprint(target) == saved_fp
                      and [r["step"] for r in report["rejected"]]
                      == [CKPT_STEPS + 2]
                      and mgr.all_steps() == [CKPT_STEPS, CKPT_STEPS + 2])
        emit({"phase": "ckpt_corrupt", "last_restore_report": report,
              "all_steps": mgr.all_steps(), "restored_step": target.step,
              "seconds_with_fallback": fallback_s, "ok": corrupt_ok})
        del target
        empty_cache(torch, dev)
        if not corrupt_ok:
            raise AssertionError(f"ckpt_corrupt: {report}")
        shutil.rmtree(os.path.join(ckdir, "a"))

        memory_profile = os.path.join(ckdir, "memory.pickle")
        if device == "cuda":
            save_device_memory_profile(memory_profile)
        emit({"phase": "ckpt_numbers", "device": smi,
              "checkpoint_bytes": nbytes, "tensor_bytes": tensor_bytes,
              "async_save_blocking_ms_first": first_ms,
              "async_save_blocking_ms": async_ms,
              "sync_save_blocking_ms_first_then_reused": sync_ms,
              "background_commit_s_first_overlapping_a_step": first_commit_s,
              "background_commit_s": commit_s,
              "wait_after_overlapped_step_s": wait_after_step_s,
              "restore_s": restore_s, "skip_batches_ms": skip_ms,
              "step_ms_overlapping_commit": overlap_ms,
              "step_ms_alone": alone_ms, "u_step_ms": u_ms,
              "steps_ms_apart": apart_ms, "steps_ms_beside_commit": beside_ms,
              "commit_s_left_after_those_steps": beside_left_s,
              "median_ms_apart_beside": [statistics.median(apart_ms),
                                         statistics.median(beside_ms)],
              "memory_profile_bytes": os.path.getsize(memory_profile)
              if device == "cuda" else None})

        # (b) SIGTERM and restart
        run_ckpt_sigterm(ckdir, device)

        # determinism survey
        if device != "cuda":
            return launches
        out = os.path.join(ckdir, "det.json")
        t0 = time.time()
        proc = subprocess.run([sys.executable, __file__, "--det-worker",
                               out], capture_output=True, text=True,
                              timeout=600)
        if proc.returncode:
            raise AssertionError(
                f"ckpt_determinism: the survey exited {proc.returncode}:\n"
                f"{proc.stderr[-4000:]}")
        with open(out) as f:
            survey = json.load(f)
        emit({"phase": "ckpt_determinism", "seconds": time.time() - t0,
              "raises": sorted(k for k, v in survey.items() if not v["ok"]),
              "presets": survey})
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    return launches


PHASES = ("layernorm", "kernels", "xent", "serving", "train", "baseline",
          "dp", "ckpt")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="drive the port on one GPU")
    p.add_argument("--phases", default=",".join(PHASES),
                   help="comma-separated subset of " + ", ".join(PHASES)
                        + " (device and build always run)")
    p.add_argument("--dp-worker", default=None, help=argparse.SUPPRESS)
    p.add_argument("--ckpt-worker", default=None, help=argparse.SUPPRESS)
    p.add_argument("--det-worker", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.dp_worker:
        return dp_worker(args.dp_worker)
    if args.ckpt_worker:
        return ckpt_worker(args.ckpt_worker)
    if args.det_worker:
        return det_worker(args.det_worker)
    phases = set(args.phases.split(","))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import train_torch
    from distributedtensorflow_tpu_torch import models as mods
    from distributedtensorflow_tpu_torch.ops import _cuda
    from distributedtensorflow_tpu_torch.ops import attention as attn
    from distributedtensorflow_tpu_torch.ops import flash_attention as fa
    from distributedtensorflow_tpu_torch.ops import fused_xent as fx
    from distributedtensorflow_tpu_torch.ops import layernorm as ln
    from distributedtensorflow_tpu_torch import train as train_lib
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
    check_sass(_cuda)

    seconds, lap = {"build": time.time() - t0}, [time.time()]

    def done(phase):
        seconds[phase] = time.time() - lap[0]
        lap[0] = time.time()

    rows = {}
    if "layernorm" in phases:
        rows["layernorm_fwd"] = check_layernorm(torch, F, ln)
        rows["layernorm_bwd"] = check_layernorm_bwd(torch, ln)
    done("layernorm")
    if "kernels" in phases:
        rows["decode_attention"] = check_decode_attention(torch, F, attn)
        rows.update(check_flash(torch, F, fa))
        run_backward_lengths(torch, F, fa)
        run_short_seq(torch, fa, attn)
    done("kernels")
    if "xent" in phases:
        rows.update(check_fused_xent(torch, F, fx))

    done("xent")
    launches = collections.Counter()
    if "serving" in phases:
        cfg = mods.gpt_small()
        state = mods.init_params(cfg, torch.Generator().manual_seed(SEED))
        model = mods.GPTLM(cfg)
        model.load_state_dict(state)
        launches.update(run_serving(torch, _cuda, Engine, model,
                                    cfg.vocab_size))
        launches.update(run_generate(torch, _cuda, mods.generate, model,
                                     cfg.vocab_size))
        run_profile(torch, Engine, mods.generate, model, cfg.vocab_size)
        del model
        torch.cuda.empty_cache()
        launches.update(run_generate_gqa(torch, _cuda, mods, attn))
        torch.cuda.empty_cache()
        run_consistency(torch, mods, Engine, cfg, state)

    done("serving")
    if "train" in phases:
        tstate, tstep, batches, train_launches, train_row = run_train(
            torch, _cuda, train_torch)
        launches.update(train_launches)
        run_profile_train(torch, tstate, tstep, batches)
        del tstate, tstep, batches
        torch.cuda.empty_cache()
        tstate, tstep, batches = run_train_chunked(torch, _cuda, train_torch)
        run_profile_train(torch, tstate, tstep, batches,
                          "profile_train_chunked")
        del tstate, tstep, batches
        torch.cuda.empty_cache()
        launches.update(run_train_split(torch, _cuda, train_torch, fa,
                                        train_row))
        torch.cuda.empty_cache()
        launches.update(run_train_medium(torch, _cuda, train_torch))
        torch.cuda.empty_cache()
        long_launches, long_row = run_train_long(torch, _cuda, train_torch,
                                                 fa)
        launches.update(long_launches)
        torch.cuda.empty_cache()
        launches.update(run_train_long(torch, _cuda, train_torch, fa,
                                       long_row)[0])
        torch.cuda.empty_cache()
        tstate, tstep, batches, moe_launches = run_train_moe(
            torch, _cuda, train_torch)
        launches.update(moe_launches)
        run_profile_train(torch, tstate, tstep, batches, "profile_train_moe")
        del tstate, tstep, batches
        torch.cuda.empty_cache()
        for xent, impl, moe in (("chunked", "pallas", False),
                                ("fused", "pallas", False),
                                ("fused", "pallas_split", False),
                                ("fused", "pallas", True)):
            run_consistency_train(torch, mods, _cuda, fa, xent, impl, moe)
        run_consistency_bf16(torch, mods, _cuda)

    done("train")
    if "baseline" in phases:
        launches.update(run_baseline(torch, _cuda, train_torch, fa))
        for family in ("resnet", "bert"):
            run_consistency_baseline(torch, mods, train_lib, _cuda, family)

    done("baseline")
    if "dp" in phases:
        launches.update(run_dp(torch, _cuda, train_torch, fa,
                               train_row if "train" in phases else None))
    done("dp")
    if "ckpt" in phases:
        launches.update(run_ckpt(torch, _cuda, train_torch, smi))
    done("ckpt")
    emit({"phase": "seconds", **seconds})
    if phases != set(PHASES):
        print(f"chip_smoke: ran only {sorted(phases)}", file=sys.stderr)
        return 2

    sources = {
        "layernorm_fwd": ("layernorm_fwd.cu", "ops/layernorm.py:48"),
        "decode_attention": ("decode_attention.cu", "ops/attention.py:279"),
        "layernorm_bwd": ("layernorm_bwd.cu", "ops/layernorm.py:59"),
        "flash_fwd": ("flash_fwd.cu", "ops/flash_attention.py:333"),
        "flash_bwd_dq": ("flash_bwd.cu", "ops/flash_attention.py:671"),
        "flash_bwd_dkv": ("flash_bwd.cu", "ops/flash_attention.py:724"),
        "flash_bwd_fused": ("flash_bwd_fused.cu",
                            "ops/flash_attention.py:586"),
        "fused_xent_fwd": ("fused_xent_fwd.cu", "ops/fused_xent.py:136"),
        "fused_xent_dx": ("fused_xent_bwd.cu", "ops/fused_xent.py:180"),
        "fused_xent_dw": ("fused_xent_bwd.cu", "ops/fused_xent.py:214"),
    }

    def summary(name):
        src, replaces = sources[name]
        row = rows[name][0]
        return {
            "name": name, "route": "cuda",
            "source": f"distributedtensorflow_tpu_torch/csrc/{src}",
            "replaces": f"distributedtensorflow_tpu/{replaces}",
            "launches": launches.get(name, 0),
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        }

    print(smi, flush=True)
    emit({"kernels": [summary(name) for name in sources]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
