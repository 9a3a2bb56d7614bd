#!/usr/bin/env python3
"""chip_smoke.py - drive the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: the card's name and power limit, as nvidia-smi prints them;
2. build: every CUDA kernel of the serving and training paths (nine
   libraries, the dropout kernel among them), compiled with nvcc for
   sm_90a from ``distributedtensorflow_tpu_torch/csrc`` into
   ``build/torch_kernels/``, one nvcc per source, all started together;
   the SASS of the bf16 K4f
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
   GPT-2-small width (bf16, seeded random weights) answers six requests
   (phase 19, serve_cli, drives it through ``serve_torch.py``);
6. dense generate: ``generate`` at full width, batch 4 (K5 launched
   once a layer and one-token step); generate_gqa: gpt_small with one kv
   head, batch 2, a 3000-token prompt in a cache of 8192, 16 greedy
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
    routing), fp32, 2 layers, dropout 0, 2 steps, against the one-process
    step on the same global batch: losses within 1e-5 relative, BatchNorm
    buffers within 1e-5 of their max-abs and equal on both ranks, each
    kernel's launches per step and rank as derived; cifar_resnet20 again
    in its preset's bf16, within 1e-2.
15. ckpt: checkpoint and resume on gpt_lm as phase 9 builds it, cut to
    6 layers.  (a) six steps uninterrupted, twice (bit-identical), against three
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
    that does not.  ckpt_determinism: one step of every preset under
    ``--deterministic`` in a fresh process; an op without a deterministic
    CUDA version is recorded by preset.

16. trainer: the Trainer's fit loop and its telemetry.  gpt_lm at full
    width (batch 8, seq 2048, remat, the fused head, K3f) through
    ``train_torch.main`` for 12 steps with a log every 2, an eval and a
    checkpoint every 6, the flight recorder, goodput, the status server
    on port 0 and a ``--profile-dir`` window over steps 4-5: its losses
    equal, bit for bit, those of the per-step-sync loop it replaced (run
    in the phase); the window's own torch.profiler trace holds K1f 49,
    K1b 25, K2 24, K3f 12, K4f, dx and dw 1 a step, and the wrappers'
    counts over the run those of 12 steps and 20 eval forwards; a
    Callback GETs /healthz /statusz /varz /memz /flightz /goodputz at
    step 8 (each 200); ``tools/check_metrics_schema.py`` (a subprocess)
    passes the logdir's metrics.jsonl, flight.jsonl, goodput.json,
    captures.jsonl and metrics.prom; the records carry t_step, t_data,
    t_dispatch, t_host, the f_* shares, hbm_in_use_gib, hbm_peak_gib,
    mfu and checkpoint_saves_total.  Printed: the fit loop's t_step
    against the per-step-sync loop's step in turns, the shares, goodput
    and its buckets, the capture's, a status probe's and a flight
    event's cost, mfu beside the closed form.  trainer_gate: mnist_lenet
    with ``--eval-every 50 --target-metric accuracy --target-value 0.97``
    stops before step 2000.  trainer_ranks: two ``--trainer-worker``
    processes over gloo on the one card (gpt_lm, 2 layers, fp32, dropout
    0, 4 steps, an eval at the last): eval_loss within 1e-6 relative of
    one process on the same weights and global eval batches, the records
    carry the ranks' t_step min/median/max, rank 1 writes
    flight.1.jsonl.

17. multistep: ``--steps-per-call`` (k optimizer steps as one replayed
    CUDA graph) and the Prefetcher.  The dropout kernel against its plain
    version at a BERT-base microbatch (64 x 512 x 768, bf16 and fp32, bit
    for bit), timed beside ``torch.rand`` + ``where``.  (a) gpt_lm as phase
    16 runs it, 16 steps through ``train_torch.main`` at k = 1 and k = 4
    (logs every 4, a profiler window over steps 13-16): losses and the
    final state's fingerprint bit for bit, the wrappers' counts those of
    16 steps, the window of the k = 4 run (one replay) holding K1f 196,
    K1b 100, K2 96, K3f 48, K4f/dx/dw 4 and the k = 1 window the same;
    t_step, t_dispatch, t_data and the f_* shares of the steady windows
    (steps 5-12) and each window's device busy time, wall and idle share.
    (h) the k = 1 run again with ``--prefetch-depth 0`` (the batch copied
    in the loop's thread).  (e) dp_world1 (``--mesh data=1`` over NCCL) at
    k = 4 equals (a)'s k = 4.  (f) 8 steps at k = 4 saved and resumed to 16
    equal (a)'s k = 4; a checkpoint restored into the state of a
    k = 4 function whose graph was captured (new optimizer tensors: the
    graph is captured again) repeats the steps bit for bit.  (g) 10 steps
    at k = 4 (a tail graph of 2) equal 10 at k = 1.  (b)-(d)
    bert_mlm_packed (2 layers, dropout 0.1, k = 2), cifar_resnet20 (k =
    4, BatchNorm statistics) and gpt_moe (4 layers, k = 2) equal their
    k = 1 runs bit for bit.  (i) ``--mesh data=1 --dist-backend gloo`` on
    the card refuses k > 1, naming NCCL.

18. presets2: the ViT and the seq2seq encoder-decoder.  imagenet_vit
    (ViT-S/16, 224x224, bf16) at the largest of 1024, 512, 256 images the
    card holds, and t5_seq2seq (seq2seq_small, S 256, B 64) through
    ``train_torch.build``, 1+3 steps each, rows as phase 13's (step ms,
    examples and tokens/s, flops, MFU, peak memory, the warm-up batch's
    loss falling), a profile of two steps, one eval step each (seq2seq's
    accuracy through
    ``chunked_argmax``); the ViT launches K1f and K1b 25 times a step,
    the seq2seq step no kernel.  Greedy ``seq2seq_generate`` from the
    trained seq2seq (B 64 of the 256-token inputs, 32 new tokens): K5 six
    times a one-token step (192 in all), ms a token against the plain
    decode path; in fp32 its tokens equal the plain path's, in bf16 the
    plain path fed its tokens picks each but at near ties (1e-2).  K1f
    and K1b at the ViT's rows (B x 196 by 384: bf16, and ln_f's bf16 to
    fp32 with fp32 dy) and K5 at the seq2seq decode (B 64, H 8, a cache
    of 512) against their plain twins; consistency_baseline's fp32 step
    for ViT-S/16 (2 layers) and seq2seq_small (2 + 2 layers) against the
    CPU; both presets at k = 4 equal k = 1 bit for bit (2 layers).

19. serve_cli (run right after phase 8): ``serve_torch.main``, the
    port's ``serve.py``, on a thread with port 0, serving GPT-2-small at
    full width (seeded random weights, ``--max-context`` 2048) over HTTP
    to localhost.  First verify_window: the speculative verify pass's
    logits against one-token steps on the same pool (bf16, a window of
    5, within 1e-4; JAX's batched form beside it for the record).  Then
    16 greedy requests of 5-600 prompt tokens at half length and
    SERVE_CLI_NEW_TOKENS new tokens (8 share a 256-token header, 4
    periodic, one streamed, two tenants) in four
    modes, (a) the defaults, (b) ``--prefix-cache --prefill-budget 64``
    with ``--kv-blocks`` at half of full provisioning, (c)
    ``--fused-sampling``, (d) ``--fused-sampling --speculate 4``, each in
    fp32 and in bf16: every request ok, every block free at the end,
    cached + prefilled tokens equal the prompt's, K1f launched 25 times a
    prefill chunk and a decode step, prefix hits in (b), accepted <=
    drafted and >= 1 token a step in (d), a seeded sampled request
    repeating in (c); fp32 tokens equal in all modes and equal dense
    ``generate``'s; in bf16 a token leaves (a)'s only where (a)'s own
    logits of the two lie within 1e-2 (each case reported).  TTFT p50/p99,
    TPOT p50, tokens/s, prefix hit rate, acceptance, tokens a step, and
    the idle share of a profiled window in (a) and (d).  Last, a
    checkpoint ``train_torch`` wrote (gpt_lm, one step) served through
    ``--checkpoint`` gives the in-memory model's tokens.

20. bert_moe: the bert_moe preset (BERT-base, eight experts with
    expert-choice routing on blocks 1, 3, ..., 11, bf16, seq 512, 256 in
    four microbatches) through ``train_torch.build``, 1+2 steps, a row as
    phase 13's with the flops predicted beside the counted ones; K1f and
    K1b 104 times a step, the dropout kernel 200 times; each MoE block's
    routing at the first step (each expert's kept count, the shares of
    tokens chosen by 0, 1 and >= 2 experts); a profile of two steps; the
    router on the card against the CPU over the first block's logits of
    one microbatch (32768 tokens, 8 experts): the same token sets but at
    boundary ties (counted); bf16 against fp32 first-step losses at
    --test-size (1e-2); 2 layers at k = 2 equal k = 1 bit for bit.
21. optim: lamb on bert_mlm (cut to 4 layers), lars on imagenet_resnet50 (256), adafactor
    on t5_seq2seq and lion on gpt_lm, each 1+3 steps through
    ``--optimizer`` beside the preset's own optimizer (step ms each), a
    profiled step's device time and its optimizer update's span, and the
    card's first update against the CPU's from the same parameters and
    gradients (1e-4 of the largest update); then gpt_lm with lion on a
    warm-up cosine schedule at k = 4 against k = 1, bit for bit.
22. records: imagenet_resnet50-shaped record shards (224x224x3 fp32,
    ~0.9 GB, written by the port's ``write_record_shards`` into a
    temporary directory that the phase removes), 1+4 steps at 256
    through ``train_torch.main --data-dir`` beside synthetic batches
    (images/s, t_data, f_data); the step's first batch equals the
    records' first, a resume from step 2 fast-forwards to their third;
    one ``--config`` JSON run of mnist_lenet.  (The build phase compiles
    the record library from ``native/src`` with g++.)
23. dataservice: the input plane.  (a) gpt_lm as phase 9 runs it
    (full width, bf16, B 8 x S 2048) for 12 steps through
    ``train_torch.main --data-service 2 --adaptive-prefetch --logdir``:
    a loopback dispatcher and two in-process data workers on the raw
    wire, read by the streaming client; every record carries the
    adaptive ``data_prefetch_depth`` and ``data_client_window`` (both >=
    1) and one fetch histogram a worker, and K1f, K1b, K2, K3f, K4f and
    K4b launch phase 9's counts a step.  (b) the same at ``--data-service
    1``: its losses equal, bit for bit, those of a run fed the worker's
    own stream (seed + 1009) in-process, whose median step ms stands
    beside the service's.  (c) imagenet_resnet50 at batch 256 through
    ``--data-service 2 --adaptive-prefetch`` beside the in-process
    synthetic feed: images/s, the data-wait share (f_data) and the
    adaptive depths step by step (a 224x224x3 fp32 batch is 154 MB, so
    the 256 MB budget holds the depth at 1).

24. planes: the operations planes.  gpt_lm at full width (B 8, S 2048,
    bf16, fused head, K3f) through ``train_torch.main`` for 8 steps with
    ``--dynamics-every 2``, ``--status-port 0``, ``--fleet``, the example
    SLO and alert rules and a ``--logdir``, at ``--steps-per-call`` 1 and
    4: dynamics rows on steps 2, 4, 6, 8, equal at k = 4 and k = 1;
    ``/dynamicz``, ``/fleetz``, ``/sloz``, ``/alertz`` and ``/histz``
    answer mid-run, and ``/healthz?deep=1`` fails exactly on the SLOs
    whose gauges the process's registry holds burning from the start (a
    whole run's trainer phase leaves goodput_fraction 0.12, whose fast
    burn 2.9 exceeds 2.0: 503 with ``failing: ["slo"]``; alone: 200);
    the logdirs pass
    ``tools/check_metrics_schema.py``, ``run_report.py`` and
    ``doctor.py``.  Step 2's stats against a plain fp64 recomputation
    from a snapshot of the parameters on the card and the plain gradients
    of its batch (relative error printed, bound 1e-4); a step off the
    cadence launches the port's kernels as a step on it and the device's
    kernels as a step without dynamics (torch.profiler).  The median step
    ms without dynamics and off and on the cadence at k = 1 and 4, with
    peak memory (one build at each k, its steps with and without dynamics
    taking turns on one state).  NaN provenance: a NaN into block 5's MLP weight at a
    step boundary (the JAX package's chaos drill), the pass names ``h5``
    by its activation taps and every later module counts the NaN through
    K1f and K2; its ms, host syncs and launches.  ``serve_torch`` over
    HTTP on GPT-2-small, the serve_cli mix at mode (a) in bf16, with the
    planes off and then on (history 0.5 s, the SLO rules, a TTFT rule
    set to fire, ``--alert-webhook`` at a loopback receiver): tokens/s
    and TPOT of each run; with the planes on the webhook gets the firing,
    ``/histz``, ``/sloz``, ``/alertz`` and ``/usagez`` answer,
    ``history.jsonl`` holds the tenants' pinned usage series and the
    logs pass the schema checker.

25. scaleout: quantised training and the model and batch axes.  (a)
    gpt_lm's four block GEMMs at 16384 tokens (768->2304, 768->768,
    768->3072, 3072->768, bf16 operands quantised per channel): the
    int8 accumulator of ``torch._int_mm`` equals the fp64 product of the
    same codes, fp8's (``torch._scaled_mm``, unit scales, fp32 out)
    within 2e-3 of its max-abs, each timed beside bf16 ``F.linear`` and
    the quantise pass; a ``QuantDense`` at each of those GEMMs on a (8,
    2048, in) input, at int8, int8_stochastic and fp8: its output equal
    to the fp64 product of its codes rescaled by ``sx * sw`` (fp8 within
    2e-3 plus bf16's rounding), its straight-through gradients within
    4e-3 of the fp64 products; gpt_lm as phase 9 runs it at ``--quant
    int8`` and ``fp8`` (1+3 steps: median ms, MFU on the bf16 rate, peak
    GiB, phase 9's launches), the first loss within 2e-2 of ``--quant
    none``'s (a smoke check: the first loss is near ln V whatever the
    blocks return), and one ``int8_stochastic`` step.  (b) two ``--scaleout-worker``
    processes over gloo on the one card, ``--mesh data=1,model=2``:
    gpt_lm at full width cut to 2 layers (12 heads, E 768, V 50257),
    dropout 0, one step in fp32 and in bf16, each rank on 6 heads and its
    25129 or 25128 vocab rows, K1f, K1b, K2, K3f, K4f and K4b launched
    their derived counts; losses and the put-together gradients against
    one process on the same batch (fp32 1e-5 and 1e-4 of each max-abs,
    bf16 2e-2 and 1e-1); ``--mesh data=1,model=1`` over NCCL equals
    phase 9's losses bit for bit.  (c) the same processes at ``--mesh
    data=2``, fp32: ``--zero`` within 1e-5 of the plain step with about
    half its optimizer state (tensors and the allocator's growth over
    the first step), ``--overlap`` bit-equal to it (bucket count and
    coverage printed).  No gloo time is a scaling time.
26. seqexpert: K2/K3f/K3 with ``kv_segment_ids`` against their twins,
    beside the one-array call and SDPA (forward and eager backward) with
    the segment mask; lm_long_context over ``seq=2`` (ring, Ulysses) and
    the MoE presets over ``expert=2`` in two gloo processes on the card
    against one process (``run_seqexpert``).
27. pipeline: gpt_lm at full width cut to 4 layers over ``--mesh
    data=1,pipe=2`` in two gloo processes on the card: GPipe, circular
    GPipe, 1F1B and interleaved in fp32 and bf16 against one process's
    dense model on the same weights, 1F1B and interleaved against GPipe,
    the bf16 wire bit for bit, each rank's K2/K3f launches against the
    derived counts, the loss pass's memory under 1F1B below GPipe's, a
    bf16 step's ms of each schedule; ``pipe=1`` over NCCL against phase
    9 bit for bit (``run_pipeline``).
28. splitckpt: checkpoints, ``--clipnorm`` and LAMB over the split axes.
    In the same two gloo processes: gpt_lm at full width cut to 2 layers
    (batch 2, S 1024) over ``data=1,model=2`` and ``data=1,pipe=2``
    (1F1B), gpt_moe over ``data=1,expert=2``, fp32 and bf16, AdamW with
    ``--clipnorm 1.0``: 4 steps with an async save of step 2 (the save's
    blocking ms), a fresh build from another seed, ``restore_latest``
    (its seconds), ``skip_batches`` and steps 3-4 equal the
    uninterrupted run bit for bit (losses, fingerprint), K1f, K1b, K2,
    K3f (and the fused head's K4f/K4b on model and expert) launched in
    the resumed steps on every rank; the fp32 model=2 and pipe=2
    checkpoints restored into one process give each rank's pieces bit for
    bit, and one clipped step there equals the split step 3; one LAMB
    step over model=2 equals one process's (``run_splitckpt``).
29. splitzero: in the same two gloo processes, gpt_lm at full width cut
    to 2 layers (gpt_moe over expert), batch 2: one ``--dynamics-every
    1`` step over ``data=1,seq=2`` (S 2048), ``data=1,expert=2``,
    ``data=1,pipe=2`` (1F1B) and ``data=2 --zero``, fp32 and bf16, each
    rank's ``dynamics/`` values bit-equal to the other's and to one
    process's statistics of the gathered whole gradients and parameters
    within 1e-5; ``--quant int8`` and ``fp8`` over pipe=2 in fp32, the
    loss within 1e-5 of the dense quantised model's in this process
    (``run_splitzero``).
30. quad: four gloo processes on the card, started with the split
    workers (after every phase that times a kernel): ``--zero
    --overlap`` over ``data=2,seq=2``, ``data=2,expert=2`` (gpt_moe, no
    token dropped) and ``data=2,pipe=2`` (1F1B), 2 fp32 steps against
    one process's from the same weights and global batch (losses 1e-5,
    first-step gradients 1e-4 of each max-abs, update norms 1e-3), each
    rank's optimizer state half the unsharded, K1f/K1b/K2/K3f launched on
    every rank (K4f/K4b too over expert), and the bf16 step's ms with and
    without ``--zero --overlap`` (``run_quad``; no scaling time).
31. jobs (run after phase 23): the ``--job`` roles.  (a) gpt_lm at full
    width cut to 2 layers (B 8 x S 2048, bf16, the fused head) trains 4
    steps through ``train_torch.main`` with a checkpoint every 2 while
    ``train_torch.main --job evaluator`` polls the directory on another
    thread (``--poll-interval 0.2``, ``--steps`` the last step): it
    evaluates the last step, and its eval_loss equals, within 1e-6
    relative, ``weighted_evaluate`` of that step restored in this
    process on the same 10 batches; K1f, K1b, K2, K3f, K4f and K4b
    launch the trainer's steps' counts plus, for each evaluation, 10
    eval forwards (K1f 2L+1, K2 L, K4f 1 each); each evaluation's ms.
    (b) ``--job async-ps --workload widedeep`` at its preset width, 2 PS
    shards (threads of this process, on the CPU) and 2 worker processes
    on the card, 8 steps of 256 a worker: the global version is workers
    x ps x steps, the staleness histogram has entries, each worker held a
    CUDA context, and the first batch worker 0 trained on has a lower
    loss under the final parameters than under the seeded initial ones;
    a second run of 30 steps a worker kills worker 1 once the version
    reaches 8, and the version still advances to the survivor's last
    step.  (c) 1 ps, 1 chief and 1 worker of one TF_CONFIG cluster as
    ``train_torch.py`` processes on loopback ports, started together:
    all exit 0 and the ps task absorbs its push budget.  (d) a
    Coordinator of two process workers with status servers: each answers
    ``/varz``, 6 slow closures run out of process while worker 0 is
    killed mid-closure (the closure re-queued, ``worker_respawns_total``
    up by one), then 4 more run on the respawned pool.  (b)-(d) start
    first, side by side, and (a) runs on the card meanwhile.

32. hostdist (run after phase 31): host-side distribution.  (a) the MPMD
    stage-per-process pipeline (``parallel.pipeline_mpmd``) at
    GPT-2-small's widths (vocab 50257, hidden 768, 12 heads, seq 1024)
    cut to 4 layers over 2 stages, microbatch 4, 4 microbatches, window
    2, fp32, 4 steps, each stage a ``spawn`` process worker of the
    ``Coordinator`` through ``run_mpmd_pipeline``: the losses fall and
    equal, bit for bit, ``reference_run``'s (the same stage modules from
    the same seeds over the same microbatches in the same order, in this
    process), whose trained stages give the first step's batch a lower
    loss than the run's first; each stage's K1f, K1b, K2 and K3f
    launches equal the derived counts (stage 0: K1f 32, K2 16, K1b 16, K3f 8 a step; the
    last: K1f 20, K2 8, K1b 20, K3f 8); each stage's step ms.  (b) the
    JAX test's kill run (hidden 64, 2 stages, 30 steps) on the card:
    worker 1's process killed after stage 0's second trace row, every
    stage closure re-queued, one respawn, the run completing with stage
    1's ``metrics.jsonl`` at steps 0..29 once each.  (c) beside (b):
    ``tools/timeline.py --fleet`` stitches (a)'s ``mpmd.step`` and
    ``pipeline.handoff`` spans into one trace, ``check_metrics_schema.py``
    passes each stage's ``metrics.jsonl`` and ``metrics.prom``,
    ``run_report.py --json`` gives schedule "mpmd", 16 handoffs (p50 and
    p99 printed) and stage 0's ``link_stalls``.  (d) started with (b):
    two children of the port's ``testing.run(..., backend="gloo")`` hold
    their rows of one array on the card: ``MultiWorkerMirroredStrategy``'s
    ``reduce`` (sum, mean, max, min over axis None, 0, 1) and ``gather``
    equal numpy's of the whole; a two-rank ``HostCollectives`` ring
    all-reduces, all-gathers, broadcasts and meets at a barrier, and
    times a 64 MiB fp32 all-reduce (the host's loopback); beside them a
    child killed by ``terminate`` is an expected exit and one asleep past
    a 5 s join raises ``SubprocessTimeoutError``.  (a) and (b) run on one
    pool of two process workers that the script starts before phase 31,
    so their imports and CUDA starts run beside it.

Kernel launch counts are set to 0 just before phases 5, 6 (each generate
run), 9-11, 13, 14 (each path; in each rank's process), 15's resumed
steps, 16's run through ``train_torch.main``, 17's runs, 18's training
steps and decoding, each server run of 19, 20's steps, each of 21's
optimizer runs, each of 23's ``train_torch.main`` runs, 24's two
``train_torch.main`` runs and its serving runs, 25's, 26's and 27's
steps, 28's resumed steps and 29's and 30's
steps (in each rank's process), 31's trainer and evaluator together,
and 32's MPMD stages (in each stage's process, over its run), and read
just after (a
replayed graph counts what its capture counted); a kernel of the path
that did not launch, or a gpt_lm, gpt_moe or BERT training step that
launched a kernel another number of times than its forward,
recomputation and backward need, fails the run.  The line before the last is one JSON
object with a row per kernel; the last line is ``{"ok": true, "device":
{...}}``.  ``--phases`` runs a subset (for iterating on one part); the
default runs all.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core rate
              "float32": 67e12,    # outside the tensor cores
              "int8": 1979e12,     # dense tensor-core rates of the
              "float8_e4m3fn": 1979e12}  # narrow types
L2_BYTES = 50 * 2**20
SEED = 0


#: The script's start: each phase or kernel row gets its seconds since
#: then as ``t_s`` (where the time goes, against the 1200 s limit).
T_START = time.time()


def emit(obj) -> None:
    if "phase" in obj or "kernel" in obj:
        obj = {**obj, "t_s": round(time.time() - T_START, 2)}
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


def check_layernorm(torch, F, ln, d=768, cases=None, path=None):
    """K1f against its plain twin at width ``d`` over ``cases`` of (rows,
    x dtype, out dtype); by default GPT's and BERT's (D 768).  ``path``
    names the preset whose shapes the rows are."""
    rows = []
    g = torch.Generator(device="cuda").manual_seed(SEED)
    gamma = 1.0 + 0.1 * torch.randn(d, device="cuda", generator=g)
    beta = 0.1 * torch.randn(d, device="cuda", generator=g)
    if cases is None:
        # decode steps; a GPT training step's rows; a BERT microbatch's
        # rows (64 x 512, fp32 in and out: its LayerNorms sum fp32
        # residuals); the gathered MLM head's (64 x 103 positions, bf16
        # in, fp32 out)
        cases = [(n, torch.bfloat16, out) for n in (4, 16, 64, 16384)
                 for out in (torch.bfloat16, torch.float32)] + [
            (32768, torch.float32, torch.float32),
            (6592, torch.bfloat16, torch.float32)]
    for n, x_dtype, out_dtype in cases:
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
            "kernel": "layernorm_fwd", "path": path, "n": n, "d": d,
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


def check_decode_attention(torch, F, attn, cases=None, path=None):
    """K5 against its plain twin: the serving shapes (gpt_small's generate:
    B 4, H 12, S 2048, D 64) with GQA, a window, a partial band and fp32;
    the groups and bands the first version refused: 12 query heads over 1
    kv head, 16 over 2 at 8192 positions, and 65536 positions at B 1.
    Each case runs three times for bit-identical outputs and names the
    plan (splits of the band) it ran.  ``cases`` (name, dtype, (B, H,
    Hkv, S), band) replace those; ``path`` names their preset."""
    rows = []
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    bf16, fp32 = torch.bfloat16, torch.float32
    d = 64
    cases = cases or [("mha", bf16, (4, 12, 12, 2048), (0, 2048)),
                      ("gqa", bf16, (4, 12, 4, 2048), (0, 2048)),
                      ("window", bf16, (4, 12, 12, 2048),
                       (2048 - 512, 2048)),
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
            "kernel": "decode_attention", "path": path, "case": name,
            "b": b, "h": h,
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


def check_layernorm_bwd(torch, ln, d=768, cases=None, path=None):
    """K1b at the training step's rows: 8 x 2048 tokens of width 768,
    bf16 x with bf16 dy (the blocks' LayerNorms) and fp32 dy (ln_f); at
    a BERT microbatch's, 64 x 512, fp32 x and dy; and at the gathered MLM
    head's, 64 x 103, bf16 x and fp32 dy.
    Each row gives the main pass's grid (``blocks``) and its two
    launches' device times apart (``main_ms``, ``reduce_ms``: the
    profiler's kernel times per call), beside the graph-replay time of
    the pair (``ms``) and, with bf16 dy, the time of one ``torch.add``
    that moves the same bytes (``stream_yardstick_ms``, timed only).
    ``cases`` of (rows, x dtype, dy dtype) at width ``d`` replace those;
    ``path`` names their preset."""
    rows = []
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gamma = 1.0 + 0.1 * torch.randn(d, device="cuda", generator=g)
    beta = 0.1 * torch.randn(d, device="cuda", generator=g)
    bf16, fp32 = torch.bfloat16, torch.float32
    # (rows, x, dy): gpt_lm's blocks and ln_f; a BERT microbatch (64 x
    # 512, fp32 residuals and fp32 cotangents); BERT's gathered MLM head
    # (64 x 103 positions)
    cases = cases or ((8 * 2048, bf16, bf16), (8 * 2048, bf16, fp32),
                      (64 * 512, fp32, fp32), (64 * 103, bf16, fp32))
    for n, x_dtype, dy_dtype in cases:
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
            "kernel": "layernorm_bwd", "path": path, "n": n, "d": d,
            "x": str(x_dtype)[6:],
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
    N was counted (``train_torch.flops_per_token``, which the Trainer's
    ``mfu`` field uses too)."""
    import train_torch

    return train_torch.flops_per_token(model, cfg, seq)


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
    """torch.profiler over two steps: the wall, the device's busy time and
    its top kernels.  The card's activity alone is traced (since PR 22):
    nothing read the host ops' trace, whose cost filled the window's
    wall."""
    from torch.profiler import ProfilerActivity, profile

    batch = [next(batches) for _ in range(2)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for bt in batch:
            state, m = step(state, bt)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.time() - t0
    kernels = device_events(torch, prof)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    if not busy:
        raise AssertionError(f"{phase}: no device time traced")
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


#: generate_gqa's prompt: 6000 tokens until PR 21; 3000 since PR 22 (the
#: one-token forwards of both paths, 20 s of the script's limit), still
#: ~3x past the band the first K5 held in shared memory
GQA_PROMPT = 3000


def run_generate_gqa(torch, cuda, mods, attn):
    """Dense ``generate`` on gpt_small at full width, cut to 2 layers,
    with one kv head (12
    query heads a group, which the first K5 refused), B 2, a GQA_PROMPT
    prompt in a cache of 8192 (past the first K5's shared-memory band),
    then 16 greedy tokens: once under ``DECODE_IMPL = "auto"`` (K5, one
    launch per layer and one-token step) and once under ``"xla"`` (the
    grouped einsum path, no K5).  The greedy tokens must be equal, and the
    next step's logits after the whole sequence agree within 1e-2 relative
    in the L2 norm (bf16: the two paths' attention outputs differ by a
    bf16 rounding here and there, which the bf16 layers carry to the
    logits; the largest single difference is reported beside it)."""
    # GQA_PROMPT + 15 one-token forwards a run, each bound by the host's launches,
    # which grow with the depth: cut to 2 layers to keep the script's
    # time
    cfg = dataclasses.replace(mods.gpt_small(), num_layers=2, num_kv_heads=1,
                              max_seq=8192)
    state = mods.init_params(cfg, torch.Generator().manual_seed(SEED + 12))
    model = mods.GPTLM(cfg)
    model.load_state_dict(state)
    prompt = torch.as_tensor(np.random.default_rng(SEED + 12).integers(
        0, cfg.vocab_size, (2, GQA_PROMPT)), device=model.device)
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
    row = {"phase": "generate_gqa", "batch": 2, "prompt": GQA_PROMPT,
           "new_tokens": new_tokens, "max_seq": cfg.max_seq,
           "layers": cfg.num_layers, "num_heads": cfg.num_heads,
           "kv_heads": cfg.kv_heads,
           "dtype": str(cfg.dtype)[6:], "same_greedy_tokens": same,
           "tokens_auto": out["auto"][:, GQA_PROMPT:].tolist(),
           "tokens_xla": out["xla"][:, GQA_PROMPT:].tolist(),
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
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            wall = time.time() - t0
        kernels = device_events(torch, prof)
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
        if not busy:
            raise AssertionError(f"profile_{name}: no device time traced")
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


#: The serve_cli phase: ``serve_torch.main`` at full width over HTTP.
#: Each mode adds its flags to the engine's defaults (4 slots, blocks of
#: 16, prefill chunk 16); (b)'s pool is half of full provisioning.
SERVE_CLI_MODES = (
    ("a_defaults", ()),
    ("b_prefix_budget_half_pool", ("--prefix-cache", "--prefill-budget",
                                   "64", "--kv-blocks", "half")),
    ("c_fused", ("--fused-sampling",)),
    ("d_speculate", ("--fused-sampling", "--speculate", "4")),
)
SERVE_CLI_CONTEXT = 2048
#: New tokens a request (64, then 32, until the whole script neared its
#: 1200 s limit: cut to 8, the checks unchanged).
SERVE_CLI_NEW_TOKENS = 8
#: Prompt lengths are divided by this: 2 on the card (1 until the whole
#: script neared its 1200 s limit; the shared header is still 8 blocks of
#: 16); a CPU rehearsal cuts it further together with the config.
SERVE_CLI_SCALE = 2
SERVE_CLI_TIE = 1e-2
SERVE_CLI_TENANTS = ("tenant_a", "tenant_b")
SERVE_CLI_STREAMED = 5  # the index of the one streamed request


def _serve_cli_mix(vocab, scale=1):
    """16 prompts, 5 to 600 tokens: 8 share a 256-token header (16
    blocks of 16), 4 are periodic (the n-gram drafter fires on them), 4
    are random; interleaved so that header requests keep arriving."""
    rng = np.random.default_rng(SEED + 15)

    def ints(n):
        return rng.integers(0, vocab, max(n // scale, 1)).tolist()

    header = ints(256)
    shared = [header + ints(n) for n in (5, 40, 100, 200, 300, 344, 17, 64)]
    periodic = []
    for n, period in ((48, 7), (96, 11), (160, 13), (300, 9)):
        pattern = ints(period * scale)
        periodic.append((pattern * (n // len(pattern) + 1))[:max(
            n // scale, 2 * len(pattern))])
    other = [ints(n) for n in (5, 33, 128, 450)]
    return [shared[0], periodic[0], other[0], shared[1], periodic[1],
            shared[2], other[1], shared[3], periodic[2], shared[4],
            other[2], shared[5], periodic[3], shared[6], other[3],
            shared[7]]


def _http(port, path, payload=None, timeout=900):
    """``(status, body text)`` of a GET (no payload) or a JSON POST to
    this process's server on ``port``."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _generate(port, payload) -> dict:
    """One ``POST /generatez``: the blocking reply, or a streamed reply's
    token lines joined under its trailer's stats."""
    status, body = _http(port, "/generatez", payload)
    if status != 200:
        raise AssertionError(f"POST /generatez {status}: {body[:300]}")
    if not payload.get("stream"):
        return json.loads(body)
    lines = [json.loads(line) for line in body.splitlines()]
    out = dict(lines[-1])
    if not out.get("done") or out.get("status") != "ok":
        raise AssertionError(f"stream ended with {out}")
    out["tokens"] = [t for line in lines[:-1] for t in line["tokens"]]
    out["stream_lines"] = len(lines) - 1
    return out


class _CliServer:
    """``serve_torch.main(argv, stop=...)`` on a thread; the port from its
    startup line on stdout."""

    def __init__(self, serve_torch, argv):
        import io
        import threading

        self.stop = threading.Event()
        self.rc = None
        self.error = None
        buf = io.StringIO()

        def run():
            try:
                self.rc = serve_torch.main(argv, stop=self.stop)
            except BaseException as e:  # noqa: BLE001 - reported below
                self.error = e

        self.thread = threading.Thread(target=run, name="serve_cli")
        t0 = time.time()
        deadline = t0 + 300
        with contextlib.redirect_stdout(buf):
            self.thread.start()
            while '"serving": true' not in buf.getvalue():
                if self.error is not None or not self.thread.is_alive() \
                        or time.time() > deadline:
                    raise AssertionError(
                        f"serve_torch did not start: {self.error!r} "
                        f"{buf.getvalue()[:300]}")
                time.sleep(0.05)
        self.startup = json.loads(buf.getvalue().strip().splitlines()[0])
        self.port = self.startup["port"]
        self.start_s = time.time() - t0

    def close(self) -> int:
        self.stop.set()
        self.thread.join(timeout=300)
        if self.error is not None or self.thread.is_alive():
            raise AssertionError(f"serve_torch failed: {self.error!r}")
        return self.rc


def _serve_mix(port, prompts, new_tokens):
    """Every prompt POSTed at once from its own thread (one streamed, two
    tenants); returns the replies in prompt order and the wall seconds."""
    import threading

    replies = [None] * len(prompts)
    errors = []

    def client(i, prompt):
        try:
            replies[i] = _generate(port, {
                "prompt": prompt, "max_new_tokens": new_tokens,
                "tenant": SERVE_CLI_TENANTS[i % 2],
                "stream": i == SERVE_CLI_STREAMED})
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i, p))
               for i, p in enumerate(prompts)]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.time() - t0
    if errors:
        raise errors[0]
    return replies, wall


def _profiled_window(torch, port, prompts, new_tokens):
    """torch.profiler over four requests of the mix served at once: wall,
    device-busy time and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        _serve_mix(port, prompts[:4], new_tokens)
        torch.cuda.synchronize()
        wall = time.time() - t0
    busy = sum(e.self_device_time_total
               for e in device_events(torch, prof)) / 1e3
    return {"wall_ms": 1e3 * wall, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / (1e3 * wall)}


def _serve_cli_mode(torch, cuda, serve_torch, argv, prompts, new_tokens,
                    logdir, device, ln_per_step, sampled=False,
                    profile=False):
    """One server run: the mix, then (``sampled``) one seeded sampled
    request twice, (``profile``) a profiled window; every check that
    needs only this run, K1f's ``ln_per_step`` launches a prefill chunk
    and a decode step among them.  Launch counts are set to 0 just before
    the server starts and read after it stopped."""
    dev = torch.device(device)
    sync(torch, dev)
    cuda.launches.clear()
    srv = _CliServer(serve_torch, argv)
    extra = {}
    try:
        replies, wall = _serve_mix(srv.port, prompts, new_tokens)
        if sampled:
            kw = {"prompt": prompts[2], "max_new_tokens": new_tokens,
                  "temperature": 0.8, "top_k": 40, "seed": 7}
            runs = [_generate(srv.port, kw)["tokens"] for _ in range(2)]
            extra["sampled_repeat"] = runs[0] == runs[1]
            extra["sampled_tokens"] = runs[0][:16]
        if profile and dev.type == "cuda":
            extra["profile"] = _profiled_window(torch, srv.port, prompts,
                                                new_tokens // 2)
        state = json.loads(_http(srv.port, "/generatez")[1])
    finally:
        rc = srv.close()
    sync(torch, dev)
    launches = dict(cuda.launches)
    extra["server_start_s"] = srv.start_s
    rows = [json.loads(line) for line in open(f"{logdir}/requests.jsonl")]
    kv = state["kv"]
    problems = []
    if rc != 0:
        problems.append(f"serve_torch exited {rc}")
    if any(r["status"] != "ok" for r in rows):
        problems.append("a request did not end ok")
    if any(r["cached_prefix_tokens"] + r["prefill_tokens"]
           != r["prompt_tokens"] for r in rows):
        problems.append("cached + prefilled tokens != prompt tokens")
    if kv["blocks_used"] or kv["blocks_free"] + kv["blocks_cached"] \
            != kv["blocks_total"]:
        problems.append(f"blocks not free at the end: {kv}")
    if any(len(r["tokens"]) != new_tokens for r in replies):
        problems.append("a reply has another number of tokens")
    if sampled and not extra["sampled_repeat"]:
        problems.append("a seeded sampled request did not repeat")
    steps = state["prefill_chunks"] + state["decode_steps"]
    if dev.type == "cuda" \
            and launches.get("layernorm_fwd") != ln_per_step * steps:
        problems.append(f"K1f launched {launches.get('layernorm_fwd')} "
                        f"times for {state['prefill_chunks']} prefill chunks "
                        f"and {state['decode_steps']} decode steps, "
                        f"expected {ln_per_step} each")
    return replies, wall, state, launches, extra, problems


def _first_divergence(torch, model, context, prompt, ref, got):
    """Where ``got`` first leaves ``ref`` (the default mode's tokens): the
    position, both tokens and, from the default path's own logits there
    (an Engine at its defaults serving the request alone, its host
    sampler's input recorded), the gap between the two tokens' logits
    and the top-2 margin."""
    from distributedtensorflow_tpu_torch.serve import Engine

    j = next(i for i, (a, b) in enumerate(zip(ref, got)) if a != b)
    eng = Engine(model, max_context=context)
    rows = []
    sample = eng._sample

    def record(req, logits):
        rows.append(np.asarray(logits, np.float32))
        return sample(req, logits)

    eng._sample = record
    req = eng.submit(prompt, max_new_tokens=j + 1)
    while not req._done.is_set():
        eng.step()
    eng.stop()
    last = rows[j]
    top2 = np.sort(last)[-2:]
    return {"position": j, "default_token": ref[j], "mode_token": got[j],
            "default_path_reproduced": req.tokens == ref[:j + 1],
            "logit_gap": float(last[ref[j]] - last[got[j]]),
            "top2_margin": float(top2[1] - top2[0])}


def _batched_verify(torch, attn, q, k_pool, v_pool, tables, lens):
    """JAX's form of the verify attention (``ops/attention.py:222`` of the
    JAX package): the T queries of a window in one einsum, for the
    record beside the port's per-position form."""
    b, t, h, d = q.shape
    k, v = attn._paged_kv(k_pool, v_pool, tables)
    h_kv, cap = k.shape[1], k.shape[2]
    g = h // h_kv
    ends = lens[:, None] + torch.arange(t, device=q.device)[None, :]
    valid = torch.arange(cap, device=q.device)[None, None, :] \
        < ends[:, :, None]
    scores = torch.einsum("bthgd,bhkd->bhgtk",
                          q.reshape(b, t, h_kv, g, d).float(), k)
    scores = torch.where(valid[:, None, :, :],
                         scores.reshape(b, h, t, cap) / (d ** 0.5),
                         attn.NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype).reshape(b, h_kv, g, t, cap)
    out = torch.einsum("bhgtk,bhkd->bthgd", w.float(), v)
    return out.reshape(b, t, h, d).to(q.dtype)


def check_verify_window(torch, mods, attn, config="gpt_small", device="cuda",
                        window=5, slots=4):
    """The verify pass's logits against one-token steps on the same pool
    (bf16, seeded random weights, 4 slots prefilled to 32-304 tokens, a
    window of 5 random tokens): the port's per-position form within 1e-4
    of the steps (fp32 rounding of the head), JAX's batched form beside
    it for the record."""
    from distributedtensorflow_tpu_torch.ops.xent import tied_head_logits
    from distributedtensorflow_tpu_torch.serve import model as serve_model
    from distributedtensorflow_tpu_torch.serve.kv_cache import PagedKVCache

    dev = torch.device(device)
    cfg = getattr(mods, config)()
    model = mods.GPTLM(cfg, device=dev)
    model.load_state_dict(mods.init_params(
        cfg, torch.Generator().manual_seed(SEED)))
    bs, context = 16, 1024
    rng = np.random.default_rng(SEED + 16)
    kv = PagedKVCache(num_layers=cfg.num_layers, kv_heads=cfg.kv_heads,
                      head_dim=cfg.head_dim, max_slots=slots,
                      num_blocks=slots * context // bs, block_size=bs,
                      max_context=context, dtype=cfg.dtype, device=dev)
    prefill = serve_model.make_prefill_fn(cfg, chunk=bs, block_size=bs)
    for s in range(slots):
        n = bs * int(rng.integers(2, 20))
        kv.admit(s, n + 2 * window)
        cache = model.init_cache(1, context)
        ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, n)),
                              device=dev)
        for start in range(0, n, bs):
            prefill(model, kv.k_pool, kv.v_pool, cache,
                    ids[:, start:start + bs], start, kv.block_tables[s],
                    bs - 1)
        kv.note_written(s, n)
    tables = torch.as_tensor(kv.block_tables.astype(np.int64), device=dev)
    seq = torch.as_tensor(kv.seq_lens.astype(np.int64), device=dev)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (slots, window)),
                             device=dev)
    pools = (kv.k_pool.clone(), kv.v_pool.clone())

    def logits(tok, pos, attend):
        kv.k_pool.copy_(pools[0])
        kv.v_pool.copy_(pools[1])
        rows = tables.gather(1, pos // bs) * bs + pos % bs
        xf = serve_model._paged_forward(cfg, model, kv.k_pool, kv.v_pool, tok,
                                        pos, rows.reshape(-1), attend)
        return tied_head_logits(xf, model.wte.weight, cfg.dtype)

    with torch.no_grad():
        steps = []
        for t in range(window):
            kv.k_pool.copy_(pools[0])
            kv.v_pool.copy_(pools[1])
            for u in range(t + 1):  # the steps before t write their K/V
                pos = (seq + u)[:, None]
                rows = tables.gather(1, pos // bs) * bs + pos % bs

                def one(q, kl, vl, u=u):
                    return attn.paged_verify_attention(q, kl, vl, tables,
                                                       seq + 1 + u)

                xf = serve_model._paged_forward(
                    cfg, model, kv.k_pool, kv.v_pool, tokens[:, u:u + 1],
                    pos, rows.reshape(-1), one)
            steps.append(tied_head_logits(xf, model.wte.weight, cfg.dtype))
        steps = torch.cat(steps, dim=1)
        pos = seq[:, None] + torch.arange(window, device=dev)[None, :]
        port = logits(tokens, pos, lambda q, kl, vl: attn.paged_verify_attention(
            q, kl, vl, tables, seq + 1))
        batched = logits(tokens, pos, lambda q, kl, vl: _batched_verify(
            torch, attn, q, kl, vl, tables, seq + 1))
    err = (port - steps).abs().max().item()
    row = {"phase": "verify_window", "config": config, "dtype": "bfloat16",
           "slots": slots, "window": window,
           "max_abs_logit_diff": err,
           "batched_form_max_abs_logit_diff": (
               batched - steps).abs().max().item(),
           "tolerance": "1e-4 against one-token steps on the same pool"}
    emit(row)
    del model, kv, pools
    empty_cache(torch, dev)
    if not err <= 1e-4:
        raise AssertionError(f"the verify pass leaves the one-token steps: "
                             f"{row}")


@contextlib.contextmanager
def _cached_init(mods):
    """``models.init_params`` (which ``serve_torch.build_model`` draws the
    seeded weights with) drawn once a config and seed inside the block:
    the phase's server runs serve the same weights (the dtype casts them
    after), so the later runs skip the draw."""
    real, cache = mods.init_params, {}

    def init_params(cfg, generator):
        key = (repr(dataclasses.replace(cfg, dtype=None)),
               generator.initial_seed())
        if key not in cache:
            cache[key] = real(cfg, generator)
        return cache[key]

    mods.init_params = init_params
    try:
        yield
    finally:
        mods.init_params = real


def run_serve_cli(torch, cuda, serve_torch, train_torch, mods, attn,
                  config="gpt_small", device="cuda", smi=""):
    """``serve_torch.main`` (the port's ``serve.py``) on port 0 at full
    width (seeded random weights, ``--max-context`` 2048), serving the
    16-request mix of :func:`_serve_cli_mix` over HTTP in modes (a)-(d)
    of SERVE_CLI_MODES, each in fp32 and in bf16.  fp32: every mode's
    greedy tokens equal (a)'s and dense ``generate``'s.  bf16: a token of
    (b)-(d) may leave (a)'s only where (a)'s two candidates lie within
    1e-2 of each other (each case reported).  Every mode: requests ok,
    every block free at the end, cached + prefilled == prompt tokens,
    K1f launched 25 times a prefill chunk and a decode step; (b)
    prefix_hits > 0; (d) accepted <= drafted and tokens a step >= 1; (c)
    seeded sampled requests repeat.  Then a ``--checkpoint`` run of a
    checkpoint ``train_torch`` wrote for gpt_lm serves the in-memory
    model's tokens.  Returns the launches of the mode runs."""
    import os
    import shutil
    import tempfile

    dev = torch.device(device)
    cfg = getattr(mods, config)()
    context = min(SERVE_CLI_CONTEXT, cfg.max_seq)
    new_tokens = SERVE_CLI_NEW_TOKENS
    prompts = _serve_cli_mix(cfg.vocab_size, SERVE_CLI_SCALE)
    half = str(4 * context // 16 // 2)
    check_verify_window(torch, mods, attn, config, device)
    tmp = tempfile.mkdtemp(prefix="serve_cli_")
    launches = collections.Counter()
    tokens = {}
    try:
        with _cached_init(mods):
            for dtype in ("float32", "bfloat16"):
                for mode, flags in SERVE_CLI_MODES:
                    logdir = os.path.join(tmp, f"{mode}_{dtype}")
                    flags = [half if f == "half" else f for f in flags]
                    argv = ["--config", config, "--device", device,
                            "--port", "0", "--dtype", dtype, "--max-context",
                            str(context), "--seed", str(SEED), "--logdir",
                            logdir, *flags]
                    replies, wall, state, got, extra, problems = \
                        _serve_cli_mode(
                            torch, cuda, serve_torch, argv, prompts,
                            new_tokens,
                            logdir, device, 2 * cfg.num_layers + 1,
                            sampled=mode == "c_fused",
                            profile=dtype == "bfloat16"
                            and mode in ("a_defaults", "d_speculate"))
                    launches.update(got)
                    tokens[dtype, mode] = [r["tokens"] for r in replies]
                    c = state["counters"]
                    if mode.startswith("b") and not state["kv"]["prefix_hits"]:
                        problems.append("no prefix hit")
                    if mode.startswith("d") and not (
                            0 <= c["spec_accepted"] <= c["spec_drafted"]
                            and c["spec_drafted"] > 0
                            and state["tokens_per_step"] >= 1.0):
                        problems.append(f"speculation counts {c}")
                    ttft = [r["ttft_s"] for r in replies]
                    tpot = [r["tpot_s"] for r in replies]
                    row = {
                        "phase": "serve_cli", "mode": mode, "dtype": dtype,
                        "config": config, "flags": flags, "card": smi,
                        "requests": len(replies),
                        "prompt_tokens": sum(len(p) for p in prompts),
                        "new_tokens": sum(len(r["tokens"]) for r in replies),
                        "wall_s": wall,
                        "tokens_per_s": sum(len(r["tokens"])
                                            for r in replies) / wall,
                        "ttft_p50_s": float(np.percentile(ttft, 50)),
                        "ttft_p99_s": float(np.percentile(ttft, 99)),
                        "tpot_p50_s": float(np.percentile(tpot, 50)),
                        "prefix_hit_rate": state["kv"]["prefix_hit_rate"],
                        "prefix_hits": state["kv"]["prefix_hits"],
                        "spec_acceptance_rate": state["spec_acceptance_rate"],
                        "spec_drafted": c["spec_drafted"],
                        "spec_accepted": c["spec_accepted"],
                        "tokens_per_step": state["tokens_per_step"],
                        "decode_steps": state["decode_steps"],
                        "prefill_chunks": state["prefill_chunks"],
                        "streamed_lines": replies[SERVE_CLI_STREAMED][
                            "stream_lines"],
                        "launches": got, **extra, "problems": problems}
                    emit(row)
                    if problems:
                        raise AssertionError(f"serve_cli {mode} {dtype}: "
                                             f"{problems}")
                    gc.collect()
                    empty_cache(torch, dev)
            _serve_cli_compare(torch, mods, cfg, context, prompts, new_tokens,
                               tokens, dev)
            run_serve_cli_checkpoint(torch, serve_torch, train_torch, mods,
                                     config, prompts[:2], new_tokens, context,
                                     tmp, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def _serve_cli_compare(torch, mods, cfg, context, prompts, new_tokens,
                       tokens, dev):
    """fp32: every mode's tokens equal (a)'s and dense ``generate``'s.
    bf16: (b)-(d) leave (a)'s tokens only at near ties."""
    state = mods.init_params(cfg, torch.Generator().manual_seed(SEED))
    model = mods.GPTLM(dataclasses.replace(
        cfg, dtype=torch.float32, max_seq=context), device=dev)
    model.load_state_dict(state)
    longest = max(len(p) for p in prompts)
    padded = np.zeros((len(prompts), longest), np.int64)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
    lens = [len(p) for p in prompts]
    out = mods.generate(model, padded, max_new_tokens=new_tokens,
                        prompt_lens=lens).cpu().numpy()
    dense = [out[i, n:n + new_tokens].tolist() for i, n in enumerate(lens)]
    del model
    empty_cache(torch, dev)
    fp32 = {m: tokens["float32", m] for m, _ in SERVE_CLI_MODES}
    same = {m: t == dense for m, t in fp32.items()}
    model = mods.GPTLM(dataclasses.replace(
        cfg, dtype=torch.bfloat16, max_seq=context), device=dev)
    model.load_state_dict(state)
    ref = tokens["bfloat16", "a_defaults"]
    ties, far = [], []
    for mode, _ in SERVE_CLI_MODES[1:]:
        for i, got in enumerate(tokens["bfloat16", mode]):
            if got != ref[i]:
                case = {"mode": mode, "request": i, **_first_divergence(
                    torch, model, context, prompts[i], ref[i], got)}
                (ties if case["default_path_reproduced"]
                 and abs(case["logit_gap"]) <= SERVE_CLI_TIE
                 else far).append(case)
    del model
    empty_cache(torch, dev)
    row = {"phase": "serve_cli_tokens", "fp32_modes_equal_dense": same,
           "bf16_differing_requests": len(ties) + len(far),
           "bf16_near_ties": ties, "bf16_beyond_tie": far,
           "tolerance": "fp32: tokens equal; bf16: a differing token only "
                        f"where the two candidates' logits lie within "
                        f"{SERVE_CLI_TIE} in the default path's own "
                        "logits"}
    emit(row)
    if not all(same.values()) or far:
        bad = {m: [i for i, (a, b) in enumerate(zip(t, dense)) if a != b]
               for m, t in fp32.items()}
        raise AssertionError(f"serve_cli tokens differ: fp32 requests {bad}; "
                             f"bf16 beyond the tie tolerance {far}")


def run_serve_cli_checkpoint(torch, serve_torch, train_torch, mods, config,
                             prompts, new_tokens, context, tmp, device):
    """``train_torch.main`` trains gpt_lm one step at batch 8 and saves;
    ``serve_torch --checkpoint`` serves it; its greedy tokens equal an
    in-memory Engine's on the model restored from the same checkpoint
    (one request at a time on both)."""
    import os

    from distributedtensorflow_tpu_torch.checkpoint import CheckpointManager
    from distributedtensorflow_tpu_torch.serve import Engine
    from distributedtensorflow_tpu_torch.train import TrainState
    from distributedtensorflow_tpu_torch.workloads import get_workload

    workload, test_size = serve_torch.CONFIGS[config][1]
    ckdir = os.path.join(tmp, "ckpt")
    t0 = time.time()
    train_torch.main(["--workload", workload, "--steps", "1", "--batch-size",
                      "8", "--log-every", "1", "--checkpoint-dir", ckdir,
                      "--device", device,
                      *(("--test-size",) if test_size else ())])
    train_s = time.time() - t0
    wl = get_workload(workload, test_size=test_size)
    state = TrainState.create(wl.model_cls(wl.cfg, device=device),
                              wl.make_optimizer)
    if CheckpointManager(ckdir).restore_latest(state) is None:
        raise AssertionError(f"no checkpoint in {ckdir}")
    model = mods.GPTLM(getattr(mods, config)(), device=device)
    model.load_state_dict(state.model.state_dict())
    del state
    eng = Engine(model, max_context=context)
    memory = []
    for p in prompts:
        req = eng.submit(p, max_new_tokens=new_tokens)
        while not req._done.is_set():
            eng.step()
        memory.append(req.tokens)
    eng.stop()
    del eng, model
    gc.collect()
    srv = _CliServer(serve_torch, [
        "--config", config, "--device", device, "--port", "0",
        "--max-context", str(context), "--checkpoint", ckdir])
    try:
        served = [_generate(srv.port, {"prompt": p,
                                       "max_new_tokens": new_tokens})
                  ["tokens"] for p in prompts]
    finally:
        rc = srv.close()
    row = {"phase": "serve_cli_checkpoint", "workload": workload,
           "train_and_save_s": train_s, "requests": len(prompts),
           "equal_to_in_memory": served == memory, "rc": rc}
    emit(row)
    if served != memory or rc != 0:
        raise AssertionError(f"--checkpoint served {served} against the "
                             f"in-memory model's {memory}")


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
                   device="cuda", extra=(), on_build=None):
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
    100k-row tables once in 25 batches; that comparison is printed.)
    ``extra``: more ``train_torch`` flags; ``on_build(state)``, called
    before the warm-up step, may return a function called after it."""
    from torch.utils.flop_counter import FlopCounterMode

    from distributedtensorflow_tpu_torch.train import (
        dropout_keys,
        split_microbatches,
    )

    args = train_torch.parse_args(
        ["--workload", name, "--batch-size", str(batch), "--seed", str(SEED),
         "--device", device, *extra])
    wl, state, step, batches = train_torch.build(args)
    model = state.model
    on_card = model.device.type == "cuda"
    buffers = {k: b.clone() for k, b in model.named_buffers()}
    first = next(batches)
    after = on_build(state) if on_build else None
    with FlopCounterMode(display=False) as counter:
        state, m = step(state, first)
    flops = counter.get_total_flops()
    if after:
        after()
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
        keys = dropout_keys(SEED, 0, wl.accum_steps, 0, model.device)
        again = sum(float(loss_fn(mb, keys[i])[0])
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
    seq 512, dropout 0, the gathered head, with K1f and K1b on the card;
    "vit" is ViT-S/16 cut to 2 layers, batch 8 at 224x224, with K1f and
    K1b on the card; "seq2seq" is seq2seq_small cut to 2 + 2 layers,
    batch 2 at seq 256 with a pad tail.  (Scales drawn in [0.9, 1.1]
    instead leave this ResNet's fp32 gradients on the CPU 6.5e-2 of a
    leaf's max from an fp64 evaluation, against 7.6e-6 at 1.)  The
    attention's key biases get no gradient (a key bias shifts a query's
    scores by one constant): their values are rounding, held below 1e-6
    of the largest gradient."""
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
    elif family == "bert":
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
    elif family == "vit":
        cfg = dataclasses.replace(mods.vit_s16(), num_layers=2,
                                  dtype=torch.float32)
        state = mods.init_params(cfg, torch.Generator().manual_seed(SEED))
        batch = {"image": rng.standard_normal((8, 224, 224, 3)).astype(
                     np.float32),
                 "label": rng.integers(0, 1000, 8)}

        def loss_of(model):
            return train.classification_loss(model)
    else:  # seq2seq: seq2seq_small cut to 2 + 2 layers, a pad tail
        cfg = dataclasses.replace(mods.seq2seq_small(), enc_layers=2,
                                  dec_layers=2, dtype=torch.float32)
        state = mods.init_params(cfg, torch.Generator().manual_seed(SEED))
        ids = rng.integers(2, cfg.vocab_size, (2, 256))
        ids[1, 160:] = cfg.pad_id
        batch = {"encoder_ids": ids, "targets": ids.copy()}

        def loss_of(model):
            return mods.seq2seq_loss(model)
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
    # LayerNorms of the forward: BERT's embedding LN and two a layer,
    # the ViT's two a block and ln_f; each once backward
    lns = {"bert": 6, "vit": 5}.get(family, 0)
    ln_ok = device == "cpu" or (
        launches.get("layernorm_fwd", 0) == lns and
        launches.get("layernorm_bwd", 0) == lns)
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
                        "max-abs; K1f and K1b 6 launches each for BERT, 5 "
                        "for the ViT, none for the others",
           "launches": launches}
    emit(row)
    if not ok:
        raise AssertionError(f"card step of {row['model']} differs from the "
                             f"CPU's: {row}")


#: The two-rank check on the one card: (preset, global batch, dtype),
#: cut to DP_LAYERS layers (ResNet-20 whole), DP_STEPS steps (3 until
#: the jobs phase needed the seconds).
#: bert_mlm_packed runs its four microbatches with the flash gate at 512;
#: cifar_resnet20 also in its preset's bf16 (the card's global BatchNorm
#: on bf16 activations).
DP_RUNS = (("gpt_lm", 8, "float32"), ("bert_mlm_packed", 32, "float32"),
           ("cifar_resnet20", 256, "float32"),
           ("cifar_resnet20", 256, "bfloat16"), ("gpt_moe", 8, "float32"))
DP_LAYERS = 2
DP_STEPS = 2
#: Relative tolerance against one process, by dtype: in bf16 each rank
#: rounds the activations and gradients of its own rows.
DP_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _dp_launches(name):
    """Launches per step and rank of a DP_RUNS preset at DP_LAYERS
    layers.  GPT: :func:`_gpt_step_launches`; BERT (4 microbatches, no
    remat): 2L + 2 LayerNorms a microbatch once each way, K2 and K3f once
    a layer."""
    n = DP_LAYERS
    if name in ("gpt_lm", "gpt_moe"):
        return _gpt_step_launches(n)
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
#: Layers of (a)-(d)'s gpt_lm at full width (the whole 12 until the jobs
#: phase needed the seconds: a smaller checkpoint to commit and restore,
#: the same checks)
CKPT_LAYERS = 6
#: Steps timed apart from and beside a commit (8 until the whole script
#: neared its 1200 s limit).
CKPT_OVERLAP_STEPS = 4
CKPT_CHILD_LAYERS = 2
CKPT_CHILD_STEPS = 8
#: Batches of the determinism survey's presets (2 layers where the model
#: has layers): enough rows for every kernel of the full-width path.
DET_RUNS = (("gpt_lm", 2), ("gpt_medium_lm", 2), ("lm_long_context", 1),
            ("gpt_moe", 2), ("mnist_lenet", 128), ("cifar_resnet20", 256),
            ("imagenet_resnet50", 32), ("bert_mlm", 16),
            ("bert_mlm_packed", 16), ("widedeep", 4096),
            ("imagenet_vit", 16), ("t5_seq2seq", 8))


def ckpt_worker(argv_json) -> int:
    """The ckpt phase's child (``--ckpt-worker``): ``train_torch.main`` of
    the given arguments with gpt_lm cut to CKPT_CHILD_LAYERS layers, its
    log lines on stderr as ``train_torch.py`` prints them.  With
    ``CKPT_WORKER_GO`` in the environment the child starts Python, torch
    and its CUDA context, then waits for that file before the run (a
    relaunch started early: its run begins when the file appears; it
    also imports what its first optimizer would, which would otherwise
    lie on the critical path)."""
    import logging

    import torch

    import train_torch

    go = os.environ.get("CKPT_WORKER_GO")
    if go:
        if torch.cuda.is_available():
            torch.zeros(1, device="cuda")
        # torch.optim imports torch._dynamo at a process's first optimizer
        # (9.4 s on the H100's host): the relaunch takes it while it waits
        import torch._dynamo  # noqa: F401
        deadline = time.time() + 600
        while not os.path.exists(go):
            if time.time() > deadline:
                raise TimeoutError(f"ckpt worker: no {go}")
            time.sleep(0.1)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    with _cut_config(train_torch, num_layers=CKPT_CHILD_LAYERS):
        train_torch.main(json.loads(argv_json))
    return 0


def det_worker(out_path) -> int:
    """The determinism survey (``--det-worker``): one step of every
    preset through ``train_torch.main --deterministic`` (a fresh process:
    cuBLAS reads its workspace setting when it starts).  An op without a
    deterministic CUDA version raises; its message is recorded for the
    preset and the survey goes on.  Any other failure fails the run."""
    import train_torch

    results = {}
    for name, batch in DET_RUNS:
        argv = ["--workload", name, "--batch-size", str(batch), "--steps",
                "1", "--log-every", "1", "--seed", str(SEED),
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


def _child(argv, err, go=None):
    """A ckpt worker of ``argv``, its stdout piped, its stderr to the
    file ``err``; with ``go`` its run waits for that file."""
    env = {**os.environ, "CKPT_WORKER_GO": go} if go else None
    return subprocess.Popen(
        [sys.executable, __file__, "--ckpt-worker", json.dumps(argv)],
        stdout=subprocess.PIPE, stderr=err, text=True, env=env)


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
    the last step, with the last loss of an uninterrupted child, which
    runs beside the first two (they record no time).  The relaunch's
    process starts beside the first child and begins its run once the
    first has exited (its Python, torch and CUDA start hidden; until the
    whole script neared its 1200 s limit it started then)."""
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
            go = os.path.join(ckdir, "relaunch.go")
            child = _child(argv(cut), files[0])
            whole = _child(argv(os.path.join(ckdir, "whole")), files[2])
            again = _child(argv(cut), files[1], go=go)
            procs += [child, whole, again]
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
            with open(go, "w") as f:
                f.write("go\n")
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


def _ckpt_a_to_d(torch, cuda, train_torch, smi, device, ckdir):
    """:func:`run_ckpt`'s (a), (c) and (d) in ``ckdir``; the resumed
    steps' launches."""
    import os
    import shutil

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
    # a sync save of the same state, timed whole (its host buffers
    # allocated: a second one reusing them measured the same within
    # 2% and went when the whole script neared its 1200 s limit)
    sync_mgr = CheckpointManager(os.path.join(ckdir, "s"), max_to_keep=1,
                                 async_save=False)
    t0 = time.perf_counter()
    sync_mgr.save(1, state)
    sync_ms = 1e3 * (time.perf_counter() - t0)
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
                    _gpt_step_launches(wl.cfg.num_layers))

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
          "sync_save_blocking_ms": sync_ms,
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

    return launches


def run_ckpt(torch, cuda, train_torch, smi, device="cuda"):
    """The checkpoint plane on gpt_lm at full width (cut to CKPT_LAYERS
    layers on the card).  (a) U, the uninterrupted run, twice; R:
    CKPT_STEPS steps, an async save, a fresh build whose weights come
    from another seed, ``restore_latest``, ``skip_batches`` and
    CKPT_STEPS more steps: R's losses and final fingerprint equal U's bit
    for bit, and the resumed steps launch the train phase's kernels their
    derived counts for those layers.  (b) SIGTERM and restart
    (:func:`run_ckpt_sigterm`).  (c) A flipped byte in the newest step is
    rejected and the step before restored; a directory without its commit
    marker is not a step.  (d) The checkpoint's bytes, the blocking ms of
    an async and a sync save, the background commit, the restore, the
    fast-forward, and a step that overlaps a commit beside one that does
    not (then CKPT_OVERLAP_STEPS of each).  Then the determinism survey
    (:func:`det_worker`).  ``device`` "cpu" rehearses it at test size (no
    survey, no memory profile)."""
    import os
    import shutil
    import tempfile

    ckdir = tempfile.mkdtemp(prefix="dtf_ckpt_")
    cut = _cut_config(train_torch, num_layers=CKPT_LAYERS) \
        if device == "cuda" else contextlib.nullcontext()
    try:
        with cut:
            launches = _ckpt_a_to_d(torch, cuda, train_torch, smi, device,
                                    ckdir)

        # (b) SIGTERM and restart, beside the determinism survey's process
        # (neither records a time)
        if device != "cuda":
            run_ckpt_sigterm(ckdir, device)
            return launches
        out = os.path.join(ckdir, "det.json")
        t0 = time.time()
        with open(os.path.join(ckdir, "det.log"), "w") as log:
            proc = subprocess.Popen(
                [sys.executable, __file__, "--det-worker", out],
                stdout=log, stderr=subprocess.STDOUT)
            try:
                run_ckpt_sigterm(ckdir, device)
                proc.wait(timeout=600)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if proc.returncode:
            raise AssertionError(
                f"ckpt_determinism: the survey exited {proc.returncode}:\n"
                f"{_read(os.path.join(ckdir, 'det.log'))[-4000:]}")
        with open(out) as f:
            survey = json.load(f)
        emit({"phase": "ckpt_determinism", "seconds": time.time() - t0,
              "raises": sorted(k for k, v in survey.items() if not v["ok"]),
              "presets": survey})
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    return launches


#: The trainer phase: gpt_lm through train_torch.main (steps, log and
#: eval period, the capture window), the A/B of the fit loop against the
#: per-step-sync loop (rounds, steps a round, log period), the accuracy
#: gate's run, and the two ranks' run.
TRAINER_STEPS, TRAINER_LOG, TRAINER_EVAL = 12, 2, 6
TRAINER_PROFILE = (3, 2)
TRAINER_PROBE_STEP = 8
AB_ROUNDS, AB_STEPS, AB_LOG = 2, 10, 5
GATE_ARGS = ("--eval-every", "50", "--target-metric", "accuracy",
             "--target-value", "0.97", "--steps", "2000", "--log-every",
             "50")
RANKS_STEPS = 4
STATUS_PATHS = ("/healthz", "/statusz", "/varz", "/memz", "/flightz",
                "/goodputz")
#: A kernel's symbol in a torch.profiler trace -> its wrapper's launch
#: key (K1b's main pass only: its final sum is a second launch a call;
#: K4b's template argument OWN_TOKENS tells dx, true, from dw).
TRACE_KERNELS = (("ln_bwd_reduce", None), ("ln_fwd", "layernorm_fwd"),
                 ("ln_bwd", "layernorm_bwd"),
                 ("flash_bwd_fused", "flash_bwd_fused"),
                 ("flash_bwd_dq", "flash_bwd_dq"),
                 ("flash_bwd_dkv", "flash_bwd_dkv"),
                 ("flash_fwd", "flash_fwd"),
                 ("xent_fwd", "fused_xent_fwd"))


def _trace_launches(path) -> dict:
    """A capture's Chrome trace: the port's kernels by launch key
    (``found``), the count of all device kernels (``kernels``, 0 when the
    profiler saw no device) and of the host's kernel-launch calls
    (``launch_calls``), the work kernels' (not the profiler's spin
    kernels) summed and spanned ms (``busy_ms``,
    ``span_ms``) and the host's synchronizing CUDA calls by name
    (``syncs``: a step that read a value back would show one), and the
    places among the window's launches of those whose device record is
    missing (``lost_records_at``)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    found = collections.Counter()
    for e in kernels:
        name = e["name"]
        if "xent_bwd" in name:
            found["fused_xent_dx" if "true" in name else
                  "fused_xent_dw" if "false" in name else
                  "fused_xent_bwd?"] += 1
            continue
        for sym, key in TRACE_KERNELS:
            if sym in name:
                if key is not None:
                    found[key] += 1
                break
    api = [e["name"] for e in events
           if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    syncs = collections.Counter(
        n for n in api if "Synchronize" in n or "Memcpy" in n)
    work = [e for e in kernels if "spin_kernel" not in e["name"]]
    span = (max(e["ts"] + e["dur"] for e in work)
            - min(e["ts"] for e in work)) / 1e3 if work else 0.0
    # launches whose device record is missing, by their place among the
    # window's launches (the first WARMUP_LAUNCHES are the profiler's spin
    # kernels)
    recorded = {(e.get("args") or {}).get("correlation") for e in kernels}
    launches = sorted((e for e in events
                       if e.get("cat") in ("cuda_runtime", "cuda_driver")
                       and "LaunchKernel" in e["name"]),
                      key=lambda e: e["ts"])
    lost = [i for i, e in enumerate(launches)
            if (e.get("args") or {}).get("correlation") not in recorded]
    return {"found": found, "kernels": len(kernels),
            "launch_calls": len(launches), "lost_records_at": lost,
            "busy_ms": sum(e["dur"] for e in work) / 1e3,
            "span_ms": span, "syncs": dict(syncs)}


def _trainer_argv(device):
    """gpt_lm as the train phase runs it; on the CPU at test size."""
    size = ["--batch-size", "8", "--seq-len", "2048", "--remat", "on"] \
        if device == "cuda" else ["--test-size"]
    return ["--workload", "gpt_lm", *size, "--seed", str(SEED), "--device",
            device]


@contextlib.contextmanager
def _extra_callbacks(train_torch, *callbacks):
    """``train_torch``'s Trainer with ``callbacks`` added, inside the
    block."""
    make = train_torch.Trainer

    def trainer(*args, callbacks=None, **kw):
        return make(*args, callbacks=[*(callbacks or []), *extra], **kw)

    extra = list(callbacks)
    train_torch.Trainer = trainer
    try:
        yield
    finally:
        train_torch.Trainer = make


def _status_probe(train_lib, at_step):
    """A Callback that GETs STATUS_PATHS from the trainer's status server
    at ``at_step``: ``probe.answers`` path -> (status, bytes),
    ``probe.ms`` the six requests' wall ms."""
    import urllib.request

    class Probe(train_lib.Callback):
        answers, ms = {}, None

        def on_step_end(self, trainer, step, state, metrics):
            if step != at_step:
                return
            t0 = time.perf_counter()
            for path in STATUS_PATHS:
                url = f"http://127.0.0.1:{trainer.status_server.port}{path}"
                with urllib.request.urlopen(url, timeout=30) as r:
                    self.answers[path] = (r.status, len(r.read()))
            self.ms = 1e3 * (time.perf_counter() - t0)

    return Probe()


def _per_step_loop(torch, train_torch, argv, steps):
    """train_torch's loop before the Trainer: build, then one step after
    another, each loss read back to the host when its step ends; the
    losses by step, each step's wall ms (its batch fetch included) and
    the run's (state, step, batches)."""
    _, state, step, batches = train_torch.build(train_torch.parse_args(argv))
    losses, ms = {}, []
    while state.step < steps:
        t0 = time.perf_counter()
        state, m = step(state, next(batches))
        losses[state.step] = float(m["loss"])
        ms.append(1e3 * (time.perf_counter() - t0))
    return losses, ms, (state, step, batches)


def _ab_rounds(torch, train_lib, run, gbs):
    """The fit loop against the per-step-sync loop on one state, in turns
    (sync, fit, fit, sync a round): the sync loop's step ms (each step's
    loss read back), the fit's t_step of each log window (AB_LOG steps),
    and the losses' order kept."""
    state, step, batches = run

    class Windows(train_lib.Callback):
        def __init__(self):
            self.t_step = []

        def on_log(self, trainer, s, record):
            self.t_step.append(1e3 * record["t_step"])

    sync_ms, fit_ms = [], []

    def sync_round():
        nonlocal state
        for _ in range(AB_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, next(batches))
            float(m["loss"])
            sync_ms.append(1e3 * (time.perf_counter() - t0))

    def fit_round():
        nonlocal state
        cb = Windows()
        cfg = train_lib.TrainerConfig(total_steps=state.step + AB_STEPS,
                                      log_every=AB_LOG,
                                      global_batch_size=gbs)
        # the fit closes the iterator it is given: a round's own
        round_batches = (next(batches) for _ in range(AB_STEPS))
        with train_lib.Trainer(step, cfg, callbacks=[cb]) as trainer:
            state = trainer.fit(state, round_batches)  # ends on a fetch
        fit_ms.extend(cb.t_step)

    for _ in range(AB_ROUNDS):
        sync_round()
        fit_round()
        fit_round()
        sync_round()
    return sync_ms, fit_ms


def _flight_cost_us(obs, n=20000):
    """Host microseconds of one ``step`` flight event (the one a step
    records)."""
    rec = obs.FlightRecorder(2048)
    t0 = time.perf_counter()
    for i in range(n):
        rec.record("step", step=i, k=1)
    return 1e6 * (time.perf_counter() - t0) / n


def trainer_worker(argv_json) -> int:
    """One rank of the trainer phase's eval over ranks (``--trainer-worker``):
    ``train_torch.main`` of the given arguments with gpt_lm cut as the dp
    phase cuts it (DP_LAYERS layers, dropout 0)."""
    import train_torch
    from distributedtensorflow_tpu_torch.ops import flash_attention as fa

    with _dp_preset(train_torch, fa, "gpt_lm"):
        train_torch.main(json.loads(argv_json))
    return 0


def _rows_of(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def run_trainer_ranks(torch, train_torch, fa, tmp, device="cuda"):
    """Eval over ranks: two ``--trainer-worker`` processes over gloo on the
    one card (both LOCAL_RANK 0), gpt_lm at DP_LAYERS layers, fp32,
    dropout 0, RANKS_STEPS steps, an eval at the last, a shared logdir
    and checkpoint directory; then one process restores the final step
    and evaluates the same global eval batches (both ranks' streams,
    rank-major).  eval_loss within 1e-6 relative of the one process's;
    the records carry host_aggregate's t_step spread; rank 1 wrote
    flight.1.jsonl."""
    import os

    from distributedtensorflow_tpu_torch import train as train_lib
    from distributedtensorflow_tpu_torch.checkpoint import CheckpointManager
    from distributedtensorflow_tpu_torch.data import (
        InputContext,
        device_put_batch,
    )
    from distributedtensorflow_tpu_torch.parallel import bootstrap

    logdir, ckdir = os.path.join(tmp, "ranks"), os.path.join(tmp, "ranks_ck")
    size = ["--batch-size", "8", "--seq-len", "2048"] if device == "cuda" \
        else ["--test-size"]
    argv = ["--workload", "gpt_lm", *size, "--dtype", "float32", "--seed",
            str(SEED), "--device", device, "--mesh", "data=2",
            "--dist-backend", "gloo", "--steps", str(RANKS_STEPS),
            "--log-every", "2", "--eval-every", str(RANKS_STEPS),
            "--logdir", logdir, "--flight-recorder", "--checkpoint-dir",
            ckdir]
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(bootstrap.free_port()), "WORLD_SIZE": "2",
           "LOCAL_RANK": "0"}
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, __file__, "--trainer-worker",
                               json.dumps(argv)], env={**env, "RANK": str(r)},
                              stdout=subprocess.DEVNULL)
             for r in range(2)]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if rcs != [0, 0]:
        raise AssertionError(f"trainer_ranks: the ranks exited with {rcs}")
    rows = _rows_of(os.path.join(logdir, "metrics.jsonl"))
    got = [r for r in rows if "eval_loss" in r][-1]
    with _dp_preset(train_torch, fa, "gpt_lm"):
        args = train_torch.parse_args(argv[:argv.index("--mesh")])
        wl, state, _, _ = train_torch.build(args)
    assert CheckpointManager(ckdir).restore_latest(state).step == RANKS_STEPS
    srcs = [wl.input_fn(InputContext(2, r, 8), SEED + 999) for r in range(2)]

    def global_batches():
        for _ in range(train_torch.EVAL_STEPS):
            parts = [next(src) for src in srcs]
            yield device_put_batch({k: np.concatenate([q[k] for q in parts])
                                    for k in parts[0]}, state.model.device)

    ref = train_lib.weighted_evaluate(
        train_lib.make_eval_step(wl.eval_fn(state.model)), state,
        global_batches())
    err = abs(got["eval_loss"] - ref["loss"]) / abs(ref["loss"])
    spread = [k for k in ("t_step_host_min", "t_step_host_median",
                          "t_step_host_max") if all(k in r for r in rows
                                                    if "loss" in r)]
    flight1 = os.path.exists(os.path.join(logdir, "flight.1.jsonl"))
    row = {"phase": "trainer_ranks", "world": 2, "backend": "gloo",
           "layers": DP_LAYERS, "dtype": "float32",
           "eval_loss": got["eval_loss"], "one_process_eval_loss":
           ref["loss"], "eval_loss_rel_err": err,
           "eval_perplexity": got.get("eval_perplexity"),
           "t_step_spread": {k: rows[-2].get(k) for k in spread},
           "flight_1_jsonl": flight1, "seconds": time.time() - t0,
           "tolerance": "eval_loss 1e-6 relative to one process on the "
                        "same weights and global eval batches"}
    emit(row)
    if err > 1e-6 or len(spread) != 3 or not flight1:
        raise AssertionError(f"trainer_ranks: {row}")


def run_trainer(torch, cuda, train_torch, fa, device="cuda"):
    """The Trainer's fit loop and its telemetry (PR 12): (1) gpt_lm at
    full width through ``train_torch.main`` with every telemetry flag
    (logdir, flight recorder, goodput, status server on port 0, a capture
    window at steps 4-5, checkpoints every 6, eval every 6): its losses
    equal the per-step-sync loop's bit for bit, the capture's own trace
    holds the path's kernels at their counts a step, the status server
    answers during the fit, the logdir passes the schema tool (a
    subprocess), the records carry the breakdown, memory, mfu and the
    checkpoint counters; its numbers (the fit loop against the
    per-step-sync loop in turns, the f_* shares, goodput, what a capture,
    a probe and the flight recorder cost, mfu beside the closed form).
    (2) mnist_lenet stops at its accuracy gate.  (3) two ranks' eval
    matches one process's (:func:`run_trainer_ranks`).  On the CPU (a
    rehearsal) the test sizes run and the kernel checks are left out."""
    import os
    import shutil
    import tempfile

    from distributedtensorflow_tpu_torch import obs
    from distributedtensorflow_tpu_torch import train as train_lib

    cuda_dev = device == "cuda"
    tmp = tempfile.mkdtemp(prefix="trainer_")
    launches = collections.Counter()
    try:
        logdir = os.path.join(tmp, "gpt")
        prof = os.path.join(logdir, "profile")
        start, n_prof = TRAINER_PROFILE
        argv = _trainer_argv(device)
        flags = ["--steps", str(TRAINER_STEPS), "--log-every",
                 str(TRAINER_LOG), "--eval-every", str(TRAINER_EVAL),
                 "--logdir", logdir, "--flight-recorder", "--goodput",
                 "--status-port", "0", "--profile-dir", prof,
                 "--profile-start", str(start), "--profile-steps",
                 str(n_prof), "--checkpoint-dir", os.path.join(tmp, "ck"),
                 "--checkpoint-every", str(TRAINER_EVAL)]
        probe = _status_probe(train_lib, TRAINER_PROBE_STEP)
        cuda.launches.clear()
        t0 = time.time()
        with _extra_callbacks(train_torch, probe):
            records = train_torch.main(argv + flags)
        main_s = time.time() - t0
        if cuda_dev:
            torch.cuda.synchronize()
        main_launches = dict(cuda.launches)
        launches.update(main_launches)
        ref, sync_ms, run = _per_step_loop(torch, train_torch, argv,
                                           TRAINER_STEPS)
        want = sorted({s for s in ref if s % TRAINER_LOG == 0}
                      | {TRAINER_STEPS})
        losses = [r["loss"] for r in records]
        failures = []
        if [r["step"] for r in records] != want \
                or losses != [ref[s] for s in want]:
            failures.append(f"losses {losses} differ from the per-step "
                            f"loop's {[ref.get(s) for s in want]}")
        # the capture's own trace: the window's steps, the path's kernels
        trace = _trace_launches(os.path.join(prof, "trace.json"))
        trace_found, n_kernels = trace["found"], trace["kernels"]
        per_step = {k: trace_found.get(k, 0) / n_prof
                    for k in TRAIN_LAUNCHES_PER_STEP}
        from distributedtensorflow_tpu_torch.utils import profiler
        lost_work = [i for i in trace["lost_records_at"]
                     if i >= profiler.WARMUP_LAUNCHES]
        if cuda_dev and (per_step != TRAIN_LAUNCHES_PER_STEP
                         or n_kernels == 0 or lost_work
                         or "fused_xent_bwd?" in trace_found):
            failures.append(f"capture trace: launches per step {per_step} "
                            f"({n_kernels} device kernels in all; the "
                            f"records of launches {lost_work} after the "
                            f"warm-up lost), expected "
                            f"{TRAIN_LAUNCHES_PER_STEP}")
        # the wrappers' counts over the run: the steps, and the evals'
        # forwards (K1f 25, K2 12, K4f 1 a batch)
        evals = (TRAINER_STEPS // TRAINER_EVAL) * train_torch.EVAL_STEPS
        eval_fwd = {"layernorm_fwd": 25, "flash_fwd": 12,
                    "fused_xent_fwd": 1}
        expected = {k: TRAINER_STEPS * v + evals * eval_fwd.get(k, 0)
                    for k, v in TRAIN_LAUNCHES_PER_STEP.items()}
        got_run = {k: main_launches.get(k, 0) for k in expected}
        if cuda_dev and got_run != expected:
            failures.append(f"launches in the run {got_run}, expected "
                            f"{expected}")
        if sorted(probe.answers) != sorted(STATUS_PATHS) or any(
                status != 200 for status, _ in probe.answers.values()):
            failures.append(f"status server answers {probe.answers}")
        files = ["metrics.jsonl", "flight.jsonl", "goodput.json",
                 "captures.jsonl", "metrics.prom"]
        schema = subprocess.run(
            [sys.executable, "tools/check_metrics_schema.py",
             *[os.path.join(logdir, f) for f in files]],
            capture_output=True, text=True, timeout=120)
        if schema.returncode:
            failures.append(f"schema: {schema.stdout[-2000:]}"
                            f"{schema.stderr[-2000:]}")
        rows = _rows_of(os.path.join(logdir, "metrics.jsonl"))
        train_rows = [r for r in rows if "loss" in r]
        need = ["t_step", "t_data", "t_dispatch", "t_host", "f_data",
                "f_dispatch", "f_host"]
        if cuda_dev:
            need += ["hbm_in_use_gib", "hbm_peak_gib", "mfu"]
        missing = [k for k in need if any(k not in r for r in train_rows)]
        if missing or "checkpoint_saves_total" not in train_rows[-1]:
            failures.append(f"records miss {missing} or the checkpoint "
                            "counter")
        # the numbers
        steady = train_rows[1:]
        med = lambda k: statistics.median(r[k] for r in steady)
        with open(os.path.join(logdir, "goodput.json")) as f:
            good = json.load(f)["merged"]
        cap = _rows_of(os.path.join(logdir, "captures.jsonl"))[0]
        wl_args = train_torch.parse_args(argv)
        state = run[0]
        per_token, _ = train_torch.flops_per_token(
            state.model, state.model.cfg, wl_args.seq_len or 64)
        t_step = med("t_step")
        tokens = 8 * (wl_args.seq_len or 64)
        flight_us = _flight_cost_us(obs)
        sync_ab, fit_ab = _ab_rounds(torch, train_lib, run,
                                     int(wl_args.batch_size or 8))
        row = {"phase": "trainer", "workload": "gpt_lm",
               "steps": TRAINER_STEPS, "losses": losses,
               "per_step_loop_losses": [ref[s] for s in want],
               "per_step_loop_ms": sync_ms, "main_seconds": main_s,
               "t_step_ms": [1e3 * r["t_step"] for r in train_rows],
               "t_step_ms_median_after_first": 1e3 * t_step,
               "f_data": med("f_data"), "f_dispatch": med("f_dispatch"),
               "f_host": med("f_host"),
               "t_dispatch_ms": 1e3 * med("t_dispatch"),
               "t_host_ms": 1e3 * med("t_host"),
               "mfu": steady[-1].get("mfu"),
               "mfu_closed_form_at_t_step":
                   per_token * tokens / steady[-1]["t_step"]
                   / PEAK_FLOPS["bfloat16"],
               "hbm_in_use_gib": train_rows[-1].get("hbm_in_use_gib"),
               "hbm_peak_gib": train_rows[-1].get("hbm_peak_gib"),
               "goodput_fraction": good["goodput_fraction"],
               "goodput_buckets": good["buckets"],
               "goodput_wall_s": good["wall_s"],
               "capture": {k: cap[k] for k in ("step_begin", "step_end",
                                               "wall_s", "overhead_s")},
               "capture_cost_ms_per_step":
                   1e3 * cap["wall_s"] / n_prof - 1e3 * t_step,
               "capture_trace_kernels": n_kernels,
               "capture_launch_calls": trace["launch_calls"],
               "capture_lost_records_at": trace["lost_records_at"],
               "capture_device_busy_ms": trace["busy_ms"],
               "capture_kernel_span_ms": trace["span_ms"],
               "capture_host_syncs": trace["syncs"],
               "t_dispatch_ms_windows": [1e3 * r["t_dispatch"]
                                         for r in train_rows],
               "t_host_ms_windows": [1e3 * r["t_host"] for r in train_rows],
               "t_data_ms_windows": [1e3 * r["t_data"] for r in train_rows],
               "capture_launches_per_step": per_step,
               "run_launches": got_run,
               "status_probe_ms": probe.ms,
               "status_answers": probe.answers,
               "flight_record_us": flight_us,
               "ab_sync_ms": sync_ab, "ab_fit_t_step_ms": fit_ab,
               "ab_sync_median": statistics.median(sync_ab),
               "ab_fit_median": statistics.median(fit_ab),
               "ab_sync_mean": statistics.mean(sync_ab),
               "ab_fit_mean": statistics.mean(fit_ab)}
        emit(row)
        del run, state
        if cuda_dev:
            torch.cuda.empty_cache()
        # (2) the accuracy gate
        gate_dir = os.path.join(tmp, "gate")
        cuda.launches.clear()
        t0 = time.time()
        gate = train_torch.main(
            ["--workload", "mnist_lenet", "--seed", str(SEED), "--device",
             device, "--logdir", gate_dir, *GATE_ARGS])
        evals = [r for r in _rows_of(os.path.join(gate_dir, "metrics.jsonl"))
                 if "eval_accuracy" in r]
        stop = evals[-1]
        emit({"phase": "trainer_gate", "workload": "mnist_lenet",
              "stopped_at": stop["step"], "eval_accuracy":
              stop["eval_accuracy"], "evals": [(r["step"], r["eval_accuracy"])
                                               for r in evals],
              "last_loss": gate[-1]["loss"], "seconds": time.time() - t0})
        if not (stop["eval_accuracy"] >= 0.97 and stop["step"] < 2000):
            failures.append(f"the accuracy gate did not stop the run: "
                            f"{stop}")
        if failures:
            raise AssertionError("trainer: " + "; ".join(failures))
        # (3) eval over ranks
        run_trainer_ranks(torch, train_torch, fa, tmp, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


#: MS_TAIL_STEPS: 10 at k = 4, two graphs of 4 and a tail of 2 (18 until
#: the whole script neared its 1200 s limit).
MS_K, MS_STEPS, MS_LOG, MS_TAIL_STEPS = 4, 16, 4, 10
#: The profiled call: steps 13-16, one k-step replay (and the same four
#: single steps at k = 1).
MS_PROFILE = (12, 4)
#: Launches of one k-step replay: MS_K times a gpt_lm step's.
MULTI_LAUNCHES_PER_CALL = {k: MS_K * v
                           for k, v in TRAIN_LAUNCHES_PER_STEP.items()}
#: name, global batch, k, layers (None: the preset's), calls of k steps.
MS_PAIRS = (("bert_mlm_packed", 32, 2, 2, 3), ("cifar_resnet20", 256, 4,
                                                None, 3),
            ("gpt_moe", 8, 2, 4, 3))
#: A BERT-base microbatch's activations (64 x 512 x 768) at the preset's
#: dropout rate, where the bert presets run the dropout kernel.
DROPOUT_SHAPE, DROPOUT_RATE = (64, 512, 768), 0.1


def check_dropout(torch, dmod, device="cuda"):
    """The dropout kernel against its plain version at a BERT-base
    microbatch's shape: bit for bit in bf16 and fp32, the kept share
    within 4 sigma of 1 - rate, another site another mask; times of the
    kernel, the plain version and ``torch.rand`` + ``where``."""
    g = torch.Generator(device=device).manual_seed(SEED)
    shape = DROPOUT_SHAPE if device == "cuda" else (4, 16, 32)
    xs = [torch.randn(shape, generator=g, device=device)
          .to(torch.bfloat16) for _ in range(3)]
    seed_v, site, rate = 1234567, 3, DROPOUT_RATE
    seed = torch.full((1,), seed_v, dtype=torch.int64, device=device)
    kernel = dmod.dropout_cuda if device == "cuda" else \
        (lambda x, s, i, r: dmod._plain_dropout(x, int(s), i, r))
    rows, failures = [], []
    for dtype in (torch.bfloat16, torch.float32):
        x = xs[0].to(dtype)
        got = kernel(x, seed, site, rate)
        ref = dmod._plain_dropout(x, seed_v, site, rate)
        other = kernel(x, seed, site + 1, rate)
        kept = float((got != 0).float().mean())
        sigma = math.sqrt(rate * (1 - rate) / x.numel())
        err = float((got.float() - ref.float()).abs().max())
        if not torch.equal(got, ref) or abs(kept - (1 - rate)) > 4 * sigma \
                or torch.equal(got, other):
            failures.append(f"{dtype}: equal {torch.equal(got, ref)}, "
                            f"kept {kept}, another site equal "
                            f"{torch.equal(got, other)}")
        nbytes = 2 * x.numel() * x.element_size() + 8
        b_ms, b_by = bound_ms(nbytes, 0, dtype)
        row = {"phase": "dropout", "name": "dropout",
               "dtype": str(dtype).removeprefix("torch."),
               "shape": list(shape), "rate": rate, "max_abs_err": err,
               "bitwise_equal": torch.equal(got, ref), "kept": kept,
               "bound_ms": b_ms, "bound_by": b_by}
        if device == "cuda":
            sets = [(xi.to(dtype),) for xi in xs]
            row["ms"] = time_ms(torch, lambda a: kernel(a, seed, site, rate),
                                sets)
            row["plain_ms"] = time_ms(
                torch, lambda a: dmod._plain_dropout(a, seed_v, site, rate),
                sets[:1], iters=4, reps=3)
            row["library_ms"] = time_ms(
                torch, lambda a: torch.where(
                    torch.rand(a.shape, device=a.device) >= rate,
                    a / (1.0 - rate), 0.0), sets, iters=20)
        emit(row)
        rows.append(row)
    if failures:
        raise AssertionError("dropout: " + "; ".join(failures))
    return rows


def _ms_main(train_torch, train_lib, argv):
    """``train_torch.main(argv)``: its records and the fingerprint of the
    state the fit ended on."""
    class End(train_lib.Callback):
        fingerprint = None

        def on_fit_end(self, trainer, state):
            End.fingerprint = _fingerprint(state)

    with _extra_callbacks(train_torch, End()):
        records = train_torch.main(argv)
    return records, End.fingerprint


def _ms_windows(rows, key, first=1, last=3):
    """``key`` of the log windows ``first``..``last - 1`` (the steady
    windows: not the first, with the kernels' load and the capture, nor
    the profiled last), in ms for times, their median."""
    vals = [r[key] * (1e3 if key.startswith("t_") else 1.0)
            for r in rows[first:last]]
    return statistics.median(vals) if vals else None


def _layer_fields(name, layers):
    """The config fields that cut ``name`` to ``layers`` layers (each of
    the seq2seq model's two stacks); none for ``layers`` None."""
    if layers is None:
        return {}
    if name == "t5_seq2seq":
        return {"enc_layers": layers, "dec_layers": layers}
    return {"num_layers": layers}


def _ms_pair(torch, train_torch, name, batch, k, layers, calls, device,
             extra=()):
    """``name`` built twice from one seed (``extra``: more flags), stepped
    ``calls * k`` steps one a call and k a call: each run's losses by
    step, fingerprint and launches of the k-step run's calls after the
    first."""
    from distributedtensorflow_tpu_torch.ops import _cuda

    out = {}
    for kk in (1, k):
        with _cut_config(train_torch, **_layer_fields(name, layers)):
            args = train_torch.parse_args(
                ["--workload", name, "--batch-size", str(batch), "--seed",
                 str(SEED), "--device", device, "--steps-per-call", str(kk),
                 *extra] + (["--test-size"] if device == "cpu" else []))
            wl, state, step, batches = train_torch.build(args)
        losses = []
        for i in range(calls * k // kk):
            if i == k // kk:
                _cuda.launches.clear()
            state, m = step(state, next(batches))
            losses += [float(v) for v in m["loss"].reshape(-1)]
        out[kk] = {"losses": losses, "fingerprint": _fingerprint(state),
                   "launches": dict(_cuda.launches),
                   "dropout": getattr(wl.cfg, "dropout_rate", None)}
        del state, step, batches
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def _ms_restore_in_place(torch, train_torch, argv, ckdir, saved):
    """A k-step function that restores a checkpoint into its own state
    after its graph was captured (the optimizer's moments are new
    tensors): 16 steps, a restore of step ``saved`` from ``ckdir`` (the
    resume run's checkpoint of those steps, the same bits as this run's
    at that step), the last 8 steps again, the same fingerprint both
    times (until the whole script neared its 1200 s limit, this run wrote
    and waited for a checkpoint of its own)."""
    from distributedtensorflow_tpu_torch.checkpoint import CheckpointManager
    from distributedtensorflow_tpu_torch.data import (
        current_input_context,
        skip_batches,
    )

    args = train_torch.parse_args(argv + ["--steps-per-call", str(MS_K)])
    wl, state, step, batches = train_torch.build(args)
    mgr = CheckpointManager(ckdir)
    for _ in range(4):
        state, m = step(state, next(batches))
    first = (_fingerprint(state), [float(v) for v in m["loss"]])
    mgr.restore(saved, state)
    ctx = current_input_context(wl.global_batch_size)
    again = train_torch.device_iter(
        args, skip_batches(wl.input_fn(ctx, args.seed), saved),
        state.model.device, bundle=MS_K)
    for _ in range(2):
        state, m = step(state, next(again))
    second = (_fingerprint(state), [float(v) for v in m["loss"]])
    graphs = len(step._fn._graphs)
    mgr.close()
    return first, second, graphs


def _ms_gloo_refuses(torch, train_torch, device):
    """steps_per_call > 1 over a gloo group on CUDA tensors raises and
    names NCCL (gpt_lm at test size, a mesh of one over gloo)."""
    from distributedtensorflow_tpu_torch.parallel import bootstrap

    args = train_torch.parse_args(
        ["--workload", "gpt_lm", "--test-size", "--device", device,
         "--mesh", "data=1", "--dist-backend", "gloo", "--steps-per-call",
         "2", "--seed", str(SEED)])
    try:
        _, state, step, batches = train_torch.build(args)
        try:
            step(state, next(batches))
        except RuntimeError as e:
            return str(e)
        return None
    finally:
        bootstrap.shutdown()


def run_multistep(torch, cuda, train_torch, device="cuda"):
    """steps_per_call (PR 13): k optimizer steps as one replayed CUDA
    graph, and the Prefetcher.  (a) gpt_lm at full width through
    ``train_torch.main`` (``Trainer.fit``), 16 steps at k = 1 and at k =
    4 from one seed: losses and the state's fingerprint bit for bit, the
    wrappers' counts those of 16 steps, a torch.profiler window over one
    k = 4 replay holding 4 steps' kernels (K1f 196, K1b 100, K2 96, K3f
    48, K4f/dx/dw 4), its device busy time, wall and idle share beside the
    k = 1 window's; t_step, t_dispatch, f_dispatch, f_data of both.  (b)
    bert_mlm_packed (2 layers, dropout 0.1), (c) cifar_resnet20 (BatchNorm
    statistics) at k = 4 and (d) gpt_moe (4 layers) at k = 2 equal their
    k = 1 runs bit for bit.  (e) dp_world1 over NCCL at k = 4 equals (a)'s
    k = 4.  (f) a k = 4 run saved at step 8 and resumed to 16 equals the
    uninterrupted one, and so does a restore into a state whose graph was
    captured (captured again).  (g) 10 steps at k = 4 (a tail graph of 2)
    equal 10 at k = 1.  (h) gpt_lm at k = 1 without the Prefetcher
    (t_data and t_step beside (a)'s).  (i) a gloo group on CUDA tensors
    refuses k > 1.  On the CPU (a rehearsal) test sizes run, without the
    profiler's and the launches' checks."""
    import os
    import shutil
    import tempfile

    from distributedtensorflow_tpu_torch import train as train_lib
    from distributedtensorflow_tpu_torch.ops import dropout as dmod

    cuda_dev = device == "cuda"
    tmp = tempfile.mkdtemp(prefix="multistep_")
    failures, launches = [], collections.Counter()
    rows = check_dropout(torch, dmod, device)
    try:
        argv = _trainer_argv(device)
        start, n_prof = MS_PROFILE

        def run(k, tag, *extra, steps=MS_STEPS, profile=True, log=MS_LOG):
            logdir = os.path.join(tmp, tag)
            flags = ["--steps", str(steps), "--log-every", str(log),
                     "--steps-per-call", str(k), "--logdir", logdir, *extra]
            if profile:
                flags += ["--profile-dir", os.path.join(logdir, "profile"),
                          "--profile-start", str(start), "--profile-steps",
                          str(n_prof)]
            cuda.launches.clear()
            t0 = time.time()
            records, fp = _ms_main(train_torch, train_lib, argv + flags)
            gc.collect()  # the run's Trainer (a reference cycle) and graphs
            if cuda_dev:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            got = dict(cuda.launches)
            train_rows = [r for r in _rows_of(os.path.join(
                logdir, "metrics.jsonl")) if "loss" in r]
            out = {"records": records, "fingerprint": fp, "launches": got,
                   "rows": train_rows, "seconds": time.time() - t0,
                   "logdir": logdir}
            if profile:
                out["trace"] = _trace_launches(
                    os.path.join(logdir, "profile", "trace.json"))
                out["capture"] = _rows_of(os.path.join(
                    logdir, "captures.jsonl"))[0]
            return out

        def same(a, b):
            return ([r["loss"] for r in a["records"]]
                    == [r["loss"] for r in b["records"]]
                    and [r["step"] for r in a["records"]]
                    == [r["step"] for r in b["records"]]
                    and a["fingerprint"] == b["fingerprint"])

        # (a): bits, launches, the profiled replay
        one = run(1, "k1")
        four = run(MS_K, "k4")
        if not same(one, four):
            failures.append(f"(a) k={MS_K} losses "
                            f"{[r['loss'] for r in four['records']]} or "
                            f"fingerprint differ from k=1's "
                            f"{[r['loss'] for r in one['records']]}")
        want = {k: MS_STEPS * v for k, v in TRAIN_LAUNCHES_PER_STEP.items()}
        for tag, r in (("k1", one), ("k4", four)):
            got = {k: r["launches"].get(k, 0) for k in want}
            if cuda_dev and got != want:
                failures.append(f"(a) {tag}: launches {got}, expected "
                                f"{want}")
        prof = {}
        for tag, r, per_call in (("k1", one, MULTI_LAUNCHES_PER_CALL),
                                 ("k4", four, MULTI_LAUNCHES_PER_CALL)):
            tr = r["trace"]
            found = {k: tr["found"].get(k, 0) for k in per_call}
            wall_ms = 1e3 * r["capture"]["wall_s"]
            prof[tag] = {"found": found, "device_busy_ms": tr["busy_ms"],
                         "kernel_span_ms": tr["span_ms"],
                         "window_wall_ms": wall_ms,
                         "idle_share_of_window": 1.0 - tr["busy_ms"]
                         / wall_ms,
                         "idle_share_of_span": 1.0 - tr["busy_ms"]
                         / tr["span_ms"] if tr["span_ms"] else None,
                         "kernels": tr["kernels"],
                         "launch_calls": tr["launch_calls"],
                         "host_syncs": tr["syncs"]}
            if cuda_dev and found != per_call:
                failures.append(f"(a) {tag} profile window: {found}, "
                                f"expected {per_call}")
        # (a) and (h): the steady windows (steps 5-12, before the profiled
        # one) of k = 1 and k = 4, and of k = 1 without the Prefetcher
        # (until the whole script neared its 1200 s limit, five timing runs
        # of their own, in turns, whose repeats added no check)
        nopf = run(1, "no_prefetch", "--prefetch-depth", "0", profile=False)
        if nopf["fingerprint"] != one["fingerprint"]:
            failures.append("(h) the run without the Prefetcher differs")
        timing = []
        for k, depth, r in ((1, 2, one), (MS_K, 2, four), (1, 0, nopf)):
            timing.append({
                "k": k, "prefetch_depth": depth,
                "t_step_ms_windows": [1e3 * x["t_step"] for x in r["rows"]],
                **{f"{key}_ms": _ms_windows(r["rows"], key) for key in
                   ("t_step", "t_dispatch", "t_data", "t_host")},
                **{key: _ms_windows(r["rows"], key) for key in
                   ("f_dispatch", "f_data", "f_host")},
                "mfu": r["rows"][1].get("mfu"), "seconds": r["seconds"]})
        launches.update(four["launches"])
        emit({"phase": "multistep", "workload": "gpt_lm", "k": MS_K,
              "steps": MS_STEPS, "losses_k1": [r["loss"] for r in
                                               one["records"]],
              "losses_k4": [r["loss"] for r in four["records"]],
              "bit_equal": same(one, four), "timing": timing,
              "profile": prof, "launches_k4": four["launches"]})
        # (e) dp_world1 over NCCL at k = 4
        if cuda_dev:
            world1 = run(MS_K, "world1", "--mesh", "data=1",
                         "--dist-backend", "nccl", profile=False)
            if not same(world1, four):
                failures.append("(e) dp_world1 at k=4 differs from (a)'s")
            emit({"phase": "multistep_world1", "bit_equal": same(world1,
                                                                   four),
                  "t_step_ms": _ms_windows(world1["rows"], "t_step"),
                  "f_dispatch": _ms_windows(world1["rows"], "f_dispatch")})
        # (f) resume at step 8 of a k = 4 run
        ck = os.path.join(tmp, "ck")
        cut = run(MS_K, "resume_a", "--checkpoint-dir", ck,
                  "--checkpoint-every", "8", steps=8, profile=False)
        resumed = run(MS_K, "resume_b", "--checkpoint-dir", ck,
                      "--checkpoint-every", "8", profile=False)
        both = [r["loss"] for r in cut["records"] + resumed["records"]]
        resume_ok = (both == [r["loss"] for r in four["records"]]
                     and resumed["fingerprint"] == four["fingerprint"])
        first, second, graphs = _ms_restore_in_place(
            torch, train_torch, argv, ck, 8)
        in_place_ok = first == second and first[0] == four["fingerprint"]
        if not resume_ok or not in_place_ok:
            failures.append(f"(f) resume {both} / fingerprint equal "
                            f"{resumed['fingerprint'] == four['fingerprint']}"
                            f", in place {first[1]} vs {second[1]}")
        emit({"phase": "multistep_resume", "losses": both,
              "bit_equal": resume_ok, "in_place_bit_equal": in_place_ok,
              "graphs_after_restore": graphs})
        # (g) the tail: a graph of 2 after the graphs of 4
        tail_k = run(MS_K, "tail4", steps=MS_TAIL_STEPS, profile=False)
        tail_1 = run(1, "tail1", steps=MS_TAIL_STEPS, profile=False)
        if not same(tail_k, tail_1):
            failures.append(f"(g) {MS_TAIL_STEPS} steps at k=4 differ from "
                            f"{MS_TAIL_STEPS} at k=1")
        emit({"phase": "multistep_tail", "steps": MS_TAIL_STEPS,
              "bit_equal": same(tail_k, tail_1),
              "losses": [r["loss"] for r in tail_k["records"]]})
        # (b)-(d): the other presets' bits
        for name, batch, k, layers, calls in MS_PAIRS:
            pair = _ms_pair(torch, train_torch, name, batch, k, layers,
                            calls, device)
            ok = (pair[1]["losses"] == pair[k]["losses"]
                  and pair[1]["fingerprint"] == pair[k]["fingerprint"])
            launches.update(pair[k]["launches"])
            emit({"phase": f"multistep_{name}", "k": k, "layers": layers,
                  "batch": batch, "dropout_rate": pair[k]["dropout"],
                  "bit_equal": ok, "losses_k1": pair[1]["losses"],
                  "losses_k": pair[k]["losses"],
                  "launches_after_first_call": pair[k]["launches"]})
            if not ok:
                failures.append(f"{name}: k={k} differs from k=1")
        # (i) gloo refuses
        if cuda_dev:
            refused = _ms_gloo_refuses(torch, train_torch, device)
            emit({"phase": "multistep_gloo", "refused": refused})
            if not refused or "NCCL" not in refused:
                failures.append(f"(i) gloo on CUDA did not refuse: "
                                f"{refused}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if failures:
        raise AssertionError("multistep: " + "; ".join(failures))
    return launches, rows

#: The presets2 phase.  imagenet_vit (ViT-S/16 at 224x224) at the
#: largest of these batches that the card holds (the preset's global
#: batch is 1024), t5_seq2seq (seq2seq_small, S 256) at its 64; each one
#: warm-up step and PRESETS2_STEPS timed ones.
PRESETS2_RUNS = (("imagenet_vit", (1024, 512, 256)), ("t5_seq2seq", (64,)))
PRESETS2_STEPS = 3
#: 25 LayerNorms a ViT-S step (ln1 and ln2 of 12 blocks, ln_f), each
#: once forward and once backward (no remat); at 196 patches the
#: attention is under the flash gate and the head is a Dense.
VIT_LAUNCHES_PER_STEP = {**NO_LAUNCHES, "layernorm_fwd": 25,
                         "layernorm_bwd": 25}
#: Greedy decoding from the trained t5_seq2seq: rows of the 256-token
#: encoder input, new tokens.  Every one-token step runs K5 once a decoder
#: layer: the priming step and all but the last token's (whose hidden
#: state nothing reads).
GEN_BATCH, GEN_NEW_TOKENS = 64, 32
#: bf16: where the plain decode path, fed the kernel run's tokens, would
#: pick another token, its logit may top the kernel run's by this much (a
#: near tie) and no more.
GEN_TIE = 1e-2
#: K5 at seq2seq_small's decode (B 64, H 8 = Hkv, D 64, a cache of 512):
#: the band of the last of 32 new tokens, the full cache, and fp32.
S2S_DECODE_CASES = (("s2s_tok32", "bfloat16", (64, 8, 8, 512), (0, 32)),
                    ("s2s_full", "bfloat16", (64, 8, 8, 512), (0, 512)),
                    ("s2s_fp32", "float32", (64, 8, 8, 512), (0, 32)))
#: The multistep pairs: (name, global batch, k, layers, calls of k).
PRESETS2_PAIRS = (("imagenet_vit", 64, 4, 2, 2), ("t5_seq2seq", 16, 4, 2, 2))


@contextlib.contextmanager
def _decode_impl(attn, impl):
    """``attn.DECODE_IMPL = impl`` inside the block, as before after."""
    old = attn.DECODE_IMPL
    attn.DECODE_IMPL = impl
    try:
        yield
    finally:
        attn.DECODE_IMPL = old


def _preset_steps(torch, cuda, train_torch, name, batches, device):
    """:func:`baseline_steps` of ``name`` at the first of ``batches`` that
    the card holds; the batches that ran out of memory, with their
    errors."""
    cut = []
    for batch in batches:
        try:
            return cut, baseline_steps(torch, cuda, train_torch, name, batch,
                                       PRESETS2_STEPS, "presets2", device)
        except torch.cuda.OutOfMemoryError as e:
            cut.append({"batch": batch, "error": str(e)[:300]})
        gc.collect()
        empty_cache(torch, torch.device(device))
    raise AssertionError(f"presets2: {name} fits at none of {batches}: {cut}")


def _eval_row(torch, train_torch, name, model, batch):
    """The preset's eval step on one of its batches: finite metrics, the
    accuracies in [0, 1] (seq2seq's through ``chunked_argmax``)."""
    from distributedtensorflow_tpu_torch.train import make_eval_step

    wl = train_torch.get_workload(name)
    metrics = {k: float(v) for k, v in make_eval_step(wl.eval_fn(model))(
        None, batch).items()}
    ok = all(math.isfinite(v) for v in metrics.values()) and all(
        0.0 <= v <= 1.0 for k, v in metrics.items() if "accuracy" in k)
    if not ok:
        raise AssertionError(f"presets2: {name}'s eval {metrics}")
    return metrics


def _plain_choices(torch, mods, attn, model, enc_ids, tokens):
    """The plain decode path (``DECODE_IMPL`` "xla") fed ``tokens``, the
    kernel run's: at each step the gap between the plain path's largest
    logit and its logit of the kernel run's token (0 where they agree),
    (B, N)."""
    from distributedtensorflow_tpu_torch.ops.xent import tied_head_logits

    cfg = model.cfg
    b, n = tokens.shape
    gaps = []
    with torch.no_grad(), _decode_impl(attn, "xla"):
        enc_out, pad, pos = model.encode(enc_ids)
        cache = model.init_cache(b)
        tok = torch.full((b, 1), cfg.bos_id, dtype=torch.long,
                         device=enc_ids.device)
        for t in range(n):
            hidden = model.decode(tok, enc_out, pad, pos,
                                  positions=torch.full_like(tok, t),
                                  cache=cache)
            logits = tied_head_logits(hidden[:, -1], model.shared.weight,
                                      cfg.dtype)
            chosen = tokens[:, t:t + 1]
            gaps.append(logits.max(-1, keepdim=True).values
                        - logits.gather(1, chosen))
            tok = chosen
    return torch.cat(gaps, dim=1)


def run_seq2seq_generate(torch, cuda, mods, attn, model, enc_ids,
                         device="cuda"):
    """Greedy ``seq2seq_generate`` from the trained t5_seq2seq (bf16):
    timed under ``DECODE_IMPL`` "auto" (K5, launch counts set to 0 just
    before and read just after: ``dec_layers`` a one-token step, the
    priming step and all but the last token's) and "xla" (the plain
    path).  The plain path fed the kernel run's tokens picks each of them
    but at near ties (its logit of the kernel's token within GEN_TIE of
    its largest).  The same weights in fp32: the kernel run's tokens equal
    the plain path's, token for token."""
    cfg = model.cfg
    n = GEN_NEW_TOKENS

    def generate(m, impl):
        with _decode_impl(attn, impl):
            out = mods.seq2seq_generate(m, enc_ids, max_new_tokens=n)
        sync(torch, m.device)
        return out

    generate(model, "auto")  # warm-up
    cuda.launches.clear()
    t0 = time.perf_counter()
    tokens = generate(model, "auto")
    kernel_s = time.perf_counter() - t0
    launches = dict(cuda.launches)
    t0 = time.perf_counter()
    plain = generate(model, "xla")
    plain_s = time.perf_counter() - t0
    gaps = _plain_choices(torch, mods, attn, model, enc_ids, tokens)
    m32 = mods.Seq2SeqLM(dataclasses.replace(cfg, dtype=torch.float32),
                         device=model.device)
    m32.load_state_dict(model.state_dict())
    t32, p32 = generate(m32, "auto"), generate(m32, "xla")
    del m32
    expected = cfg.dec_layers * n if device == "cuda" else 0
    row = {"phase": "presets2_generate", "workload": "t5_seq2seq",
           "batch": tokens.shape[0], "encoder_len": enc_ids.shape[1],
           "new_tokens": n, "dec_layers": cfg.dec_layers,
           "ms_per_token": 1e3 * kernel_s / n,
           "plain_ms_per_token": 1e3 * plain_s / n,
           "bf16_tokens_equal_plain_run": bool(torch.equal(tokens, plain)),
           "bf16_near_ties": int((gaps > 0).sum()),
           "bf16_worst_gap": float(gaps.max()),
           "fp32_tokens_equal": bool(torch.equal(t32, p32)),
           "k5_launches": launches.get("decode_attention", 0),
           "k5_launches_expected": expected,
           "tolerance": f"fp32 tokens equal; bf16: the plain path fed the "
                        f"kernel run's tokens picks each, or its logit of "
                        f"it is within {GEN_TIE} of its largest",
           "first_row": tokens[0, :12].tolist()}
    emit(row)
    if not (row["fp32_tokens_equal"] and row["bf16_worst_gap"] <= GEN_TIE
            and row["k5_launches"] == expected):
        raise AssertionError(f"presets2: seq2seq_generate {row}")
    return launches


def run_presets2(torch, cuda, train_torch, mods, attn, ln, F, train_lib,
                 device="cuda"):
    """imagenet_vit and t5_seq2seq at full width through
    ``train_torch.build`` (:func:`baseline_steps`: step ms, examples and
    tokens/s, ``FlopCounterMode`` flops and MFU, peak memory, the
    warm-up batch's loss falling; ViT at the largest batch of
    PRESETS2_RUNS the card holds, each cut listed), their launches per
    step (ViT: K1f and K1b 25 each; seq2seq: no kernel), a torch.profiler
    window over two more steps, one eval step each; greedy
    ``seq2seq_generate`` from the trained seq2seq
    (:func:`run_seq2seq_generate`); K1f and K1b at the ViT's rows (D 384:
    the blocks' bf16, ln_f's bf16 to fp32 with fp32 dy) and K5 at the
    seq2seq decode against their plain twins; the fp32 card-against-CPU
    step of both (:func:`run_consistency_baseline`); and both at k 4
    against k 1 bit for bit (PRESETS2_PAIRS).  Returns the launches of
    the training and decoding runs and the kernel rows."""
    launches = collections.Counter()
    rows = {}
    dev = torch.device(device)
    for name, batches in PRESETS2_RUNS:
        cut, (state, step, it, got, row) = _preset_steps(
            torch, cuda, train_torch, name, batches, device)
        row["batch_cut"] = cut
        row["eval"] = _eval_row(torch, train_torch, name, state.model,
                                next(it))
        emit(row)
        if device == "cuda":
            _check_launches(f"presets2 {name}", got, PRESETS2_STEPS,
                            VIT_LAUNCHES_PER_STEP if name == "imagenet_vit"
                            else NO_LAUNCHES)
        launches.update(got)
        if device == "cuda":
            run_profile_train(torch, state, step, it, f"profile_{name}")
        if name == "imagenet_vit":
            vit_rows = row["batch"] * state.model.cfg.num_patches
        else:  # decode from the trained seq2seq
            enc_ids = next(it)["encoder_ids"][:GEN_BATCH]
            launches.update(run_seq2seq_generate(
                torch, cuda, mods, attn, state.model, enc_ids, device))
            del enc_ids
        del state, step, it
        empty_cache(torch, dev)
    if device == "cuda":
        bf16, fp32 = torch.bfloat16, torch.float32
        rows["layernorm_fwd"] = check_layernorm(
            torch, F, ln, d=384, path="imagenet_vit",
            cases=[(vit_rows, bf16, bf16), (vit_rows, bf16, fp32)])
        rows["layernorm_bwd"] = check_layernorm_bwd(
            torch, ln, d=384, path="imagenet_vit",
            cases=[(vit_rows, bf16, bf16), (vit_rows, bf16, fp32)])
        rows["decode_attention"] = check_decode_attention(
            torch, F, attn, path="t5_seq2seq",
            cases=[(name, getattr(torch, dt), shape, band)
                   for name, dt, shape, band in S2S_DECODE_CASES])
        empty_cache(torch, dev)
    for family in ("vit", "seq2seq"):
        run_consistency_baseline(torch, mods, train_lib, cuda, family,
                                 device)
    failures = []
    for name, batch, k, layers, calls in PRESETS2_PAIRS:
        pair = _ms_pair(torch, train_torch, name, batch, k, layers, calls,
                        device)
        ok = (pair[1]["losses"] == pair[k]["losses"]
              and pair[1]["fingerprint"] == pair[k]["fingerprint"])
        emit({"phase": f"presets2_multistep_{name}", "k": k,
              "layers": layers, "batch": batch, "bit_equal": ok,
              "losses_k1": pair[1]["losses"], "losses_k": pair[k]["losses"],
              "launches_after_first_call": pair[k]["launches"]})
        if not ok:
            failures.append(f"{name}: k={k} differs from k=1")
    if failures:
        raise AssertionError("presets2: " + "; ".join(failures))
    return launches, rows


# ---------------------------------------------------------------- bert_moe

#: bert_moe at the preset's shape: BERT-base with 8 experts on blocks 1,
#: 3, ..., 11, seq 512, global batch 256 in four microbatches; 1 + 2 steps.
BERT_MOE_BATCH, BERT_MOE_STEPS = 256, 2
#: One bert_moe step's launches: BERT-base's 26 LayerNorms a microbatch
#: (the MoE blocks keep both of theirs) and the dropout kernel at its 25
#: sites, each forward and backward; the attention is below the flash gate.
BERT_MOE_LAUNCHES_PER_STEP = {**BERT_LAUNCHES_PER_STEP, "dropout": 200}
#: A step's flops as predicted before the first run: bert_mlm's 7.80e13
#: (FlopCounterMode, the baseline phase) plus 0.25x of the six routed
#: MLPs (each expert runs cf x T / E = 1.25 T / 8 tokens, so the experts
#: do 1.25x a dense MLP's work).
BERT_MOE_FLOPS_PREDICTED = 8.4e13
#: Router probabilities within this many fp32 ulps of an expert's boundary
#: (its capacity-th largest) are ties of the card's and the CPU's router,
#: whose softmaxes may round a last bit apart.
EC_TIE_ULPS = 4
#: The fp32 against bf16 first-step check at --test-size.
BERT_MOE_TEST_BATCH, BERT_MOE_DTYPE_TOL = 16, 1e-2
#: k steps a call against one (name, batch, k, layers, calls): the
#: routing captured in the CUDA graph, dropout on.
BERT_MOE_PAIR = ("bert_moe", 32, 2, 2, 3)


def _moe_inputs(model):
    """Pre-hooks that keep each routed MLP's first call: its input
    (B, S, d), token mask and router weights then (the first microbatch
    of the first step).  Returns ``(seen, remove)``."""
    from distributedtensorflow_tpu_torch.models.gpt_moe import MoEMLP

    seen, handles = {}, []
    for name, mod in model.named_modules():
        if not isinstance(mod, MoEMLP):
            continue

        def hook(m, args, name=name):
            if name not in seen:
                mask = args[1] if len(args) > 1 else None
                seen[name] = (args[0].detach().clone(),
                              None if mask is None else mask.detach().clone(),
                              m.router.detach().clone(), m.cfg)
        handles.append(mod.register_forward_pre_hook(hook))

    def remove():
        for h in handles:
            h.remove()

    return seen, remove


def _ec_route(torch, moe, x, mask, router, cfg):
    """The expert-choice routing of one routed MLP's input, as
    ``local_moe`` routes it: ``(logits, capacity, token mask, stats)``
    with each expert's kept count and the shares of real tokens chosen by
    0, 1 and >= 2 experts."""
    t = x.shape[0] * x.shape[1]
    logits = x.reshape(t, -1).float() @ router.float()
    cap = moe.capacity_for(t, cfg.n_experts, cfg.capacity_factor, cfg.router)
    tmask = None if mask is None else mask.reshape(t)
    token, _, keep, _ = moe.expert_choice_route(logits, cap, tmask)
    chosen = torch.bincount(token[keep], minlength=t)
    real = torch.ones(t, dtype=torch.bool, device=x.device) \
        if tmask is None else tmask.bool()
    chosen = chosen[real].float()
    stats = {"tokens": t, "capacity": min(cap, t),
             "kept_per_expert": keep.sum(1).tolist(),
             "share_chosen_by_0": float((chosen == 0).float().mean()),
             "share_chosen_by_1": float((chosen == 1).float().mean()),
             "share_chosen_by_2_or_more": float((chosen >= 2).float().mean())}
    return logits, cap, tmask, stats


def check_ec_router(torch, moe, logits, cap, tmask):
    """The expert-choice router on the card against its run on the CPU
    over the same logits: each expert's kept token set must be the
    CPU's, but for tokens whose CPU probability ties the expert's
    boundary within ``EC_TIE_ULPS`` ulps (counted); timed on the card."""
    dev = moe.expert_choice_route(logits, cap, tmask)
    cpu_mask = None if tmask is None else tmask.cpu()
    ref = moe.expert_choice_route(logits.cpu(), cap, cpu_mask)
    probs = torch.softmax(logits.cpu().float(), -1)
    ties = mismatches = 0
    for e in range(logits.shape[1]):
        got = set(dev[0][e][dev[2][e]].tolist())
        want = set(ref[0][e][ref[2][e]].tolist())
        if got == want:
            continue
        boundary = ref[1][e][min(cap, logits.shape[0]) - 1]
        ulp = float(torch.finfo(torch.float32).eps * boundary.abs())
        for tok in got ^ want:
            if abs(float(probs[tok, e] - boundary)) <= EC_TIE_ULPS * ulp:
                ties += 1
            else:
                mismatches += 1
    ms = time_ms(torch, lambda: moe.expert_choice_route(logits, cap, tmask),
                 [()], iters=20, graph=False) if logits.is_cuda else None
    row = {"phase": "bert_moe_router", "tokens": logits.shape[0],
           "experts": logits.shape[1], "capacity": min(cap, logits.shape[0]),
           "ties_at_boundary": ties, "mismatches": mismatches,
           "tie_ulps": EC_TIE_ULPS, "ms_eager": ms}
    emit(row)
    if mismatches:
        raise AssertionError(f"bert_moe: the card's expert-choice selection "
                             f"differs from the CPU's: {row}")


def _first_loss(train_torch, name, dtype, device, extra=()):
    args = train_torch.parse_args(
        ["--workload", name, "--test-size", "--batch-size",
         str(BERT_MOE_TEST_BATCH), "--seed", str(SEED), "--device", device,
         "--dtype", dtype, *extra])
    _, state, step, batches = train_torch.build(args)
    _, m = step(state, next(batches))
    return float(m["loss"])


def run_bert_moe(torch, cuda, train_torch, device="cuda"):
    """The bert_moe preset at full width through ``train_torch.build``
    (:func:`baseline_steps`: step ms, examples and tokens/s,
    ``FlopCounterMode`` flops beside the prediction, MFU, peak memory,
    the warm-up batch's loss falling), its launches a step
    (``BERT_MOE_LAUNCHES_PER_STEP``), the routing of every MoE block's
    first microbatch at the first step, a profile of two more steps, the
    router on the card against the CPU over the first block's logits
    (T 32768, E 8), the first step's loss in bf16 against fp32 at
    --test-size (1e-2), and ``BERT_MOE_PAIR``: k = 2 steps a call (one
    replayed CUDA graph) against k = 1, bit for bit.  Returns the
    launches."""
    from distributedtensorflow_tpu_torch.parallel import moe

    hooks = {}

    def on_build(state):
        hooks["seen"], remove = _moe_inputs(state.model)
        return remove

    state, step, batches, got, row = baseline_steps(
        torch, cuda, train_torch, "bert_moe", BERT_MOE_BATCH, BERT_MOE_STEPS,
        "bert_moe", device, on_build=on_build)
    routing, first = [], None
    for name, inputs in hooks.pop("seen").items():
        logits, cap, tmask, stats = _ec_route(torch, moe, *inputs)
        routing.append({"block": name, **stats})
        if first is None:
            first = (logits, cap, tmask)
        else:
            del logits
    row.update(flops_predicted=BERT_MOE_FLOPS_PREDICTED,
               routing_first_step=routing,
               n_experts=state.model.cfg.n_experts,
               router=state.model.cfg.router)
    emit(row)
    if device == "cuda":
        _check_launches("bert_moe", got, BERT_MOE_STEPS,
                        BERT_MOE_LAUNCHES_PER_STEP)
        run_profile_train(torch, state, step, batches, "profile_bert_moe")
    del state, step, batches
    empty_cache(torch, torch.device(device))
    check_ec_router(torch, moe, *first)
    del first
    losses = {dt: _first_loss(train_torch, "bert_moe", dt, device)
              for dt in ("float32", "bfloat16")}
    rel = abs(losses["bfloat16"] - losses["float32"]) / abs(
        losses["float32"])
    emit({"phase": "bert_moe_dtype", "batch": BERT_MOE_TEST_BATCH,
          "first_loss": losses, "rel_err": rel, "tol": BERT_MOE_DTYPE_TOL})
    if not all(math.isfinite(v) for v in losses.values()) \
            or rel > BERT_MOE_DTYPE_TOL:
        raise AssertionError(f"bert_moe: bf16 first loss {losses} not within "
                             f"{BERT_MOE_DTYPE_TOL} of fp32")
    name, batch, k, layers, calls = BERT_MOE_PAIR
    pair = _ms_pair(torch, train_torch, name, batch, k, layers, calls, device)
    ok = (pair[1]["losses"] == pair[k]["losses"]
          and pair[1]["fingerprint"] == pair[k]["fingerprint"])
    emit({"phase": "bert_moe_multistep", "k": k, "layers": layers,
          "batch": batch, "bit_equal": ok, "losses_k1": pair[1]["losses"],
          "losses_k": pair[k]["losses"],
          "launches_after_first_call": pair[k]["launches"]})
    if not ok:
        raise AssertionError(f"bert_moe: k={k} differs from k=1")
    return got


# ------------------------------------------------------------------- optim

#: (optimizer, the preset of its recipe, global batch, its flags).
OPTIM_RUNS = (
    ("lamb", "bert_mlm", 256, ("--lr", "2e-3", "--weight-decay", "0.01")),
    ("lars", "imagenet_resnet50", 256,
     ("--lr", "2.0", "--weight-decay", "1e-4")),
    ("adafactor", "t5_seq2seq", 64, ("--lr", "1e-2")),
    ("lion", "gpt_lm", 8, ("--lr", "3e-5", "--weight-decay", "0.1")),
)
#: Layers of each OPTIM_RUNS preset (None: its own): BERT-base's pair at
#: 2 of its 12 (the whole 12 until the jobs phase needed the seconds, 4
#: until the hostdist phase did; the update's checks are per parameter,
#: as many kinds at 2 layers)
OPTIM_LAYERS = {"bert_mlm": 2}
OPTIM_STEPS = 3
#: The card's first update against the CPU's from the same parameters and
#: gradients: max |difference| over max |update|.
OPTIM_TOL = 1e-4
#: gpt_lm with lion at k steps a call against k = 1, bit for bit.
OPTIM_PAIR_K = 4
OPTIM_PAIR_FLAGS = ("--optimizer", "lion", "--lr", "3e-5", "--weight-decay",
                    "0.1", "--schedule", "cosine", "--warmup-steps", "2")


def _capture_first_update(record):
    """``on_build`` for :func:`baseline_steps`: the parameters before the
    first update, its gradients (before clipping) and the parameters
    after it, all copied to the host."""

    def on_build(state):
        named = dict(state.model.named_parameters())
        record["before"] = {n: p.detach().cpu().clone()
                            for n, p in named.items()}
        apply = state.apply_gradients

        def capture(grads):
            record["grads"] = {n: g.detach().cpu().clone()
                               for n, g in grads.items()}
            state.apply_gradients = apply
            return apply(grads)

        state.apply_gradients = capture

        def after():
            record["after"] = {n: p.detach().cpu().clone()
                               for n, p in named.items()}
        return after

    return on_build


def _cpu_update_err(torch, train_torch, name, batch, flags, record):
    """Max |card update - CPU update| over max |CPU update| (and the
    three parameters with the largest differences): the CPU's optimizer
    built by ``train_torch`` for the same flags, on copies of the card's
    parameters and gradients."""
    args = train_torch.parse_args(["--workload", name, "--batch-size",
                                   str(batch), "--device", "cpu", *flags])
    wl = train_torch.apply_optimizer_flags(
        train_torch.get_workload(name, test_size=args.test_size,
                                 global_batch_size=batch), args)
    params = [(n, torch.nn.Parameter(p.clone()))
              for n, p in record["before"].items()]
    opt = wl.make_optimizer(params)
    for n, p in params:
        p.grad = record["grads"][n].clone()
    opt.step()
    err = top = 0.0
    worst = []
    for n, p in params:
        want = p.detach() - record["before"][n]
        got = record["after"][n] - record["before"][n]
        diff = (got - want).abs()
        err = max(err, float(diff.max()))
        top = max(top, float(want.abs().max()))
        i = int(diff.argmax())
        worst.append({"param": n, "abs_err": float(diff.max()),
                      "max_update": float(want.abs().max()),
                      "at": {"before": float(record["before"][n].flatten()[i]),
                             "grad": float(record["grads"][n].flatten()[i]),
                             "card": float(got.flatten()[i]),
                             "cpu": float(want.flatten()[i])}})
    worst = sorted(worst, key=lambda w: -w["abs_err"])[:3]
    return err / top, worst


def _optimizer_profile(torch, state, step, batches):
    """Device busy ms of one profiled step and the device span of its
    optimizer update (the profiler's ``Optimizer.step#...`` annotation),
    and the host ms of an eager update on its own."""
    from torch.profiler import ProfilerActivity, profile

    batch = next(batches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, m = step(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in device_events(torch, prof))
    span = sum(e.device_time_total for e in prof.key_averages()
               if e.key.startswith("Optimizer.step#")
               and e.device_type == torch.autograd.DeviceType.CUDA)
    for p in state.model.parameters():
        p.grad = torch.full_like(p, 1e-3)
    state.optimizer.step()  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state.optimizer.step()
    torch.cuda.synchronize()
    host = time.perf_counter() - t0
    state.optimizer.zero_grad(set_to_none=True)
    return {"profiled_step_busy_ms": busy / 1e3,
            "optimizer_span_ms": span / 1e3,
            "optimizer_share": span / busy if busy else None,
            "optimizer_eager_ms": 1e3 * host}


def run_optim(torch, cuda, train_torch, device="cuda"):
    """Each of lamb, lars, adafactor and lion at full width on its
    recipe's preset (``OPTIM_RUNS``), 1 + 3 steps through
    ``train_torch.build`` with ``--optimizer`` beside the preset's own
    optimizer: step ms each, the optimizer's share of a profiled step,
    and the card's first update against the CPU's from the same
    parameters and gradients (``OPTIM_TOL``); then gpt_lm with lion on a
    warm-up cosine schedule at k = 4 steps a call against k = 1, bit for
    bit.  Returns the launches of the optimizer runs."""
    launches = collections.Counter()
    failures = []
    for opt, name, batch, lr_flags in OPTIM_RUNS:
        flags = ("--optimizer", opt, *lr_flags)
        row = {"phase": f"optim_{opt}", "workload": name, "batch": batch,
               "optimizer": opt, "flags": list(flags)}
        cut = _layer_fields(name, OPTIM_LAYERS.get(name))
        row["layers"] = OPTIM_LAYERS.get(name)
        for tag, extra in (("default", ()), (opt, flags)):
            record = {}
            with _cut_config(train_torch, **cut):
                state, step, batches, got, run = baseline_steps(
                    torch, cuda, train_torch, name, batch, OPTIM_STEPS,
                    f"optim_{opt}_{tag}", device, extra=extra,
                    on_build=_capture_first_update(record) if tag == opt
                    else None)
            row[f"{tag}_step_ms_median"] = run["step_ms_median"]
            row[f"{tag}_step_ms"] = run["step_ms"]
            row[f"{tag}_losses"] = run["losses"]
            row[f"{tag}_optimizer"] = type(state.optimizer).__name__
            if tag == opt:
                launches.update(got)
                row["peak_mem_gib"] = run["peak_mem_gib"]
                if device == "cuda":
                    row.update(_optimizer_profile(torch, state, step,
                                                  batches))
            del state, step, batches
            empty_cache(torch, torch.device(device))
        with _cut_config(train_torch, **cut):
            row["first_update_rel_err"], row["first_update_worst"] = \
                _cpu_update_err(torch, train_torch, name, batch, flags,
                                record)
        row["tol"] = OPTIM_TOL
        del record
        emit(row)
        if row["first_update_rel_err"] > OPTIM_TOL:
            failures.append(f"{opt}: first update {row}")
    pair = _ms_pair(torch, train_torch, "gpt_lm", 8, OPTIM_PAIR_K, None, 2,
                    device, extra=OPTIM_PAIR_FLAGS)
    ok = (pair[1]["losses"] == pair[OPTIM_PAIR_K]["losses"]
          and pair[1]["fingerprint"] == pair[OPTIM_PAIR_K]["fingerprint"])
    emit({"phase": "optim_lion_multistep", "k": OPTIM_PAIR_K,
          "flags": list(OPTIM_PAIR_FLAGS), "bit_equal": ok,
          "losses_k1": pair[1]["losses"],
          "losses_k": pair[OPTIM_PAIR_K]["losses"],
          "launches_after_first_call": pair[OPTIM_PAIR_K]["launches"]})
    if not ok:
        failures.append(f"lion at k={OPTIM_PAIR_K} differs from k=1")
    if failures:
        raise AssertionError("optim: " + "; ".join(failures))
    return launches


# ----------------------------------------------------------------- records

#: imagenet_resnet50-shaped records: 224x224x3 fp32 images and labels,
#: six batches of 256 (~0.9 GB) in one shard (one reader thread, so the
#: order repeats); 1 + 4 steps.
RECORDS_BATCH, RECORDS_STEPS, RECORDS_BATCHES = 256, 4, 6
RECORDS_SHUFFLE, RECORDS_IMAGE = 512, (224, 224, 3)


def _write_image_records(d, n):
    from distributedtensorflow_tpu_torch.data import write_record_shards

    rng = np.random.default_rng(SEED)

    def examples():
        for _ in range(n):
            yield {"image": rng.standard_normal(RECORDS_IMAGE,
                                                dtype=np.float32),
                   "label": np.int32(rng.integers(1000))}

    return write_record_shards(examples(), os.path.join(d, "train-{:03d}.rec"),
                               num_shards=1)


def _fit_rows(train_torch, argv, logdir):
    """``train_torch.main`` logging every step into ``logdir``: its
    metrics rows."""
    train_torch.main([*argv, "--log-every", "1", "--logdir", logdir])
    return [r for r in _rows_of(os.path.join(logdir, "metrics.jsonl"))
            if "t_step" in r]


def _same_batch(torch, got, want) -> bool:
    return all(torch.equal(got[k].cpu(), torch.as_tensor(want[k]).to(
        got[k].dtype)) for k in want)


def run_records(torch, train_torch, device="cuda"):
    """imagenet_resnet50 from record files: shards written by the port's
    ``write_record_shards`` into a temporary directory (removed at the
    end); 1 + 4 steps at batch 256 with ``--data-dir`` beside the same
    run on synthetic batches (images/s of steps 2-5, the Trainer's
    t_data and f_data); the first batch the step sees equals the
    records' first; a run resumed from the checkpoint of step 2
    fast-forwards to the records' third batch; and one ``--config`` JSON
    run of mnist_lenet."""
    import shutil
    import tempfile

    from distributedtensorflow_tpu_torch.checkpoint import CheckpointManager
    from distributedtensorflow_tpu_torch.data import (
        InputContext,
        repeated_record_dataset,
    )

    tmp = tempfile.mkdtemp(prefix="chip_smoke_records_")
    try:
        t0 = time.time()
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        files = _write_image_records(data, RECORDS_BATCH * RECORDS_BATCHES)
        write_s = time.time() - t0
        nbytes = sum(os.path.getsize(f) for f in files)
        base = ["--workload", "imagenet_resnet50", "--batch-size",
                str(RECORDS_BATCH), "--seed", str(SEED), "--device", device]
        rec = ["--data-dir", data, "--shuffle-buffer", str(RECORDS_SHUFFLE)]
        steps = ["--steps", str(1 + RECORDS_STEPS)]
        runs = {}
        for tag, extra in (("synthetic", ()), ("records", rec)):
            rows = _fit_rows(train_torch, [*base, *steps, *extra],
                             os.path.join(tmp, tag))
            steady = rows[1:]
            t_step = statistics.median(r["t_step"] for r in steady)
            runs[tag] = {"images_per_sec": RECORDS_BATCH / t_step,
                         "t_step_ms": [1e3 * r["t_step"] for r in steady],
                         "t_data_ms": [1e3 * r.get("t_data", 0.0)
                                       for r in steady],
                         "f_data": [r.get("f_data") for r in steady],
                         "losses": [r["loss"] for r in rows]}
            empty_cache(torch, torch.device(device))
        want = repeated_record_dataset(
            files, InputContext(1, 0, RECORDS_BATCH),
            batch_size=RECORDS_BATCH, shuffle_buffer=RECORDS_SHUFFLE,
            seed=SEED)
        want = [next(want) for _ in range(3)]
        args = train_torch.parse_args([*base, *rec, *steps])
        _, _, _, batches = train_torch.build(args)
        first_ok = _same_batch(torch, next(batches), want[0])
        batches.close()
        ck = os.path.join(tmp, "ck")
        train_torch.main([*base, *rec, "--steps", "2", "--checkpoint-dir",
                          ck])
        _, state, _, batches = train_torch.build(args, CheckpointManager(ck))
        resumed_at = state.step
        resume_ok = resumed_at == 2 and _same_batch(torch, next(batches),
                                                    want[2])
        batches.close()
        del state, batches
        empty_cache(torch, torch.device(device))
        cfg = os.path.join(tmp, "mnist.json")
        with open(cfg, "w") as f:
            json.dump({"workload": "mnist_lenet", "steps": 20,
                       "log_every": 10, "seed": SEED, "device": device}, f)
        config_records = train_torch.main(["--config", cfg])
        config_ok = [r["step"] for r in config_records] == [10, 20] \
            and all(math.isfinite(r["loss"]) for r in config_records)
        row = {"phase": "records", "workload": "imagenet_resnet50",
               "batch": RECORDS_BATCH, "files": len(files),
               "record_bytes": nbytes, "write_s": write_s,
               "shuffle_buffer": RECORDS_SHUFFLE, **{
                   f"{tag}_{k}": v for tag, r in runs.items()
                   for k, v in r.items()},
               "first_batch_equal": first_ok, "resumed_at": resumed_at,
               "resume_batch_equal": resume_ok,
               "config_run": config_records, "config_ok": config_ok}
        emit(row)
        if not (first_ok and resume_ok and config_ok) or not all(
                math.isfinite(x) for x in runs["records"]["losses"]):
            raise AssertionError(f"records: {row}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


PLANES_STEPS = 8          # optimizer steps of each train_torch.main run
PLANES_EVERY = 2          # --dynamics-every of those runs
PLANES_PATHS = ("/dynamicz", "/fleetz", "/sloz", "/alertz", "/histz",
                "/healthz?deep=1")
PLANES_PROBE_STEP = 4
PLANES_SLO_RULES = "examples/slo_rules.json"
#: The first row against the plain recomputation from the snapshot, and
#: the k = 1 build's row against the main run's: relative error bound.
PLANES_TOL = 1e-4
#: (steps_per_call, dynamics_every, timed rounds): the cost of dynamics
#: on a step.  A round is one call of a step without dynamics and two of
#: the step with them over the same state, so that each round holds
#: calls on and off the cadence (at k = 4 every 8 alternates calls
#: holding a cadence step with calls that hold none).
PLANES_TIMING = ((1, 2, 8), (4, 8, 4))
PLANES_WARM_ROUNDS = 2    # the eager calls and each cadence pattern's capture
PLANES_POISON_LAYER = 5   # the block whose MLP weight the NaN goes into
#: serve_torch runs of the mix at mode (a), planes off and on.
PLANES_SERVE_RUNS = ("off", "on")
PLANES_SERVE_INTERVAL = "0.5"
#: A TTFT rule set low on purpose, so that it fires during the mix.
PLANES_FIRE_RULES = {"alerts": [{
    "name": "ttft_high", "kind": "threshold", "severity": "warn",
    "metric": "serve_ttft_seconds_avg", "op": "gt", "bound": 1e-3,
    "agg": "last", "window_s": 60, "cooldown_s": 600}]}


def _rel_errs(got: dict, want: dict) -> dict:
    """|got - want| / max(|want|, 1e-12) by key of ``want``."""
    return {k: abs(float(got[k]) - float(v)) / max(abs(float(v)), 1e-12)
            for k, v in want.items()}


def _schema(paths) -> tuple[int, str]:
    """``tools/check_metrics_schema.py`` on ``paths``, as a subprocess:
    its exit code and the end of its output."""
    run = subprocess.run([sys.executable, "tools/check_metrics_schema.py",
                          *paths], capture_output=True, text=True,
                         timeout=120)
    return run.returncode, (run.stdout + run.stderr)[-2000:]


def _planes_main(torch, cuda, train_torch, train_lib, logdir, k, device):
    """gpt_lm through ``train_torch.main`` with the dynamics cadence, the
    status server, the fleet, the SLO and alert rules; a Callback, at
    PLANES_PROBE_STEP, waits for the SLO monitor's first evaluation and
    GETs PLANES_PATHS, keeping ``/healthz?deep=1``'s body.  Launch counts
    set to 0 just before, read just after.  ``(records, launches,
    answers, deep health body, seconds)``."""

    class Probe(train_lib.Callback):
        answers, deep = {}, None

        def on_step_end(self, trainer, step, state, metrics):
            if step != PLANES_PROBE_STEP:
                return
            port = trainer.status_server.port
            deadline = time.time() + 30
            while any(r.get("pending") for r in json.loads(_http(
                    port, "/sloz?format=json", timeout=60)[1])["rules"]):
                if time.time() > deadline:
                    raise AssertionError("planes: the SLO monitor did not "
                                         "evaluate")
                time.sleep(0.05)
            for path in PLANES_PATHS:
                self.answers[path], body = _http(port, path, timeout=60)
                if path == "/healthz?deep=1":
                    self.deep = json.loads(body)

    probe = Probe()
    argv = _trainer_argv(device) + [
        "--steps", str(PLANES_STEPS), "--log-every", "2",
        "--dynamics-every", str(PLANES_EVERY), "--steps-per-call", str(k),
        "--status-port", "0", "--fleet", "--fleet-interval", "0.5",
        "--slo-rules", PLANES_SLO_RULES, "--slo-interval", "0.5",
        "--alert-rules", "examples/alert_rules.json", "--alert-interval",
        "0.5", "--logdir", logdir]
    sync(torch, torch.device(device))
    cuda.launches.clear()
    t0 = time.time()
    with _extra_callbacks(train_torch, probe):
        records = train_torch.main(argv)
    sync(torch, torch.device(device))
    return records, dict(cuda.launches), dict(probe.answers), probe.deep, \
        time.time() - t0


def _burning_gauge_slos(path) -> list[str]:
    """The SLO rules at ``path`` that a training run must find fast-burning
    from the start: the gauge rules whose gauge this process's registry
    already holds (a whole run's trainer phase leaves its
    ``goodput_fraction``) with a fast burn over the rule's limit.  A
    training run observes no serving histogram, and no page alert can
    fire within its seconds (``training_stalled`` waits 30 s, the TTFT
    burn has no traffic), so these alone fail ``/healthz?deep=1``."""
    from distributedtensorflow_tpu_torch.obs import registry

    with open(path) as f:
        rules = json.load(f)["slos"]
    reg = registry.default_registry()
    burning = []
    for rule in rules:
        gauge = reg.get(rule["metric"])
        if rule["kind"] == "histogram_under" or gauge is None:
            continue
        value = dict(gauge._items()).get(())
        if value is None or not math.isfinite(value):
            continue
        good = value if rule["kind"] == "gauge_good_fraction" else 1 - value
        good = min(max(good, 0.0), 1.0)
        if (1 - good) / (1 - rule["objective"]) > rule["fast_burn"]:
            burning.append(rule["name"])
    return burning


def _deep_health_problems(code, deep, burning) -> list[str]:
    """What is wrong with a training run's ``/healthz?deep=1`` answer
    (``code``, ``deep`` body), given the SLO rules ``burning`` from its
    start: the alerts, SLO and fleet components, only the SLO one failing
    and only for ``burning``, 503 exactly when something fails."""
    if not deep or not deep.get("deep"):
        return [f"deep health not composed: {code} {deep}"]
    comps = deep["components"]
    want = ["slo"] if burning else []
    problems = []
    if sorted(comps) != ["alerts", "fleet", "slo"]:
        problems.append(f"deep health components {sorted(comps)}")
    elif comps["slo"]["fast_burning"] != burning:
        problems.append(f"SLO fast burning {comps['slo']['fast_burning']}, "
                        f"expected {burning}")
    if deep["failing"] != want or code != (503 if want else 200):
        problems.append(f"deep health {code} failing {deep['failing']}, "
                        f"expected {want}: {comps}")
    return problems


def _planes_build(train_torch, device, every, k):
    """``train_torch.build`` of the planes' gpt_lm at ``every`` and k
    (batches copied in the caller's thread)."""
    return train_torch.build(train_torch.parse_args(
        _trainer_argv(device) + ["--dynamics-every", str(every),
                                 "--steps-per-call", str(k),
                                 "--prefetch-depth", "0"]))


def _planes_run(train_torch, train_lib, mods, device, every, k):
    """A build at ``every`` and k, with a second step over the same state
    that computes no dynamics (``none``): the state is updated in place,
    so the two steps take turns on one trajectory."""
    import types

    wl, state, step, batches = _planes_build(train_torch, device, every, k)
    none = train_lib.make_multi_train_step(
        wl.loss_fn(state.model), steps_per_call=k,
        accum_steps=wl.accum_steps, seed=SEED, dynamics_every=0,
        dynamics_modules=mods.flax_modules(wl.cfg))
    return types.SimpleNamespace(wl=wl, state=state, step=step, none=none,
                                 batches=batches, every=every, k=k)


def _plain_stats(torch, modules, old, new, grads):
    """The dynamics stats of one step recomputed plainly in fp64 from the
    parameters before (``old``) and after (``new``) and the gradients,
    keyed as the step keys them."""
    from distributedtensorflow_tpu_torch.obs import dynamics as dyn

    out, global_sq = {}, 0.0
    for name, members in dyn._groups(list(old), modules):
        def sq(ts):
            return sum(float(t.double().square().sum()) for t in ts)

        gsq = sq(grads[n] for n in members)
        pnorm = math.sqrt(sq(old[n] for n in members))
        unorm = math.sqrt(sq(new[n].detach().double() - old[n].double()
                             for n in members))
        out[f"dynamics/grad_norm/{name}"] = math.sqrt(gsq)
        out[f"dynamics/param_norm/{name}"] = pnorm
        out[f"dynamics/update_ratio/{name}"] = unorm / (pnorm + 1e-12)
        out[f"dynamics/nonfinite/{name}"] = float(sum(
            int((~torch.isfinite(grads[n])).sum()) for n in members))
        global_sq += gsq
    out["dynamics/global_grad_norm"] = math.sqrt(global_sq)
    return out


def _count_kernels(torch, fn) -> tuple[int, float]:
    """``fn()`` under torch.profiler: its device kernels and copies, and
    their summed device ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = device_events(torch, prof)
    return (sum(e.count for e in events),
            sum(e.self_device_time_total for e in events) / 1e3)


def _planes_recompute(torch, cuda, train_lib, mods, device, run, main_row):
    """The first two steps of ``run`` (k = 1, ``--dynamics-every 2``):
    the first off the cadence, the second on it.  A snapshot of the
    parameters on the card after step 1 and the plain gradients of step
    2's batch give the plain stats of step 2 (:func:`_plain_stats`), held
    against the step's own and against the main run's first row.  Each
    step's launches of the port's kernels; on the card also the device
    kernel count of a step off and on the cadence (steps 3 and 4) and of
    ``run.none`` (torch.profiler)."""
    from distributedtensorflow_tpu_torch.obs import dynamics as dyn

    dev = torch.device(device)
    wl, step, batches = run.wl, run.step, run.batches
    cuda_dev = dev.type == "cuda"
    launches, kernels = {}, {}
    b1 = next(batches)
    sync(torch, dev)
    cuda.launches.clear()
    run.state, _ = step(run.state, b1)
    sync(torch, dev)
    launches["off"] = dict(cuda.launches)
    old = {n: p.detach().float().clone()
           for n, p in run.state.model.named_parameters()}
    b2 = next(batches)
    grads, _ = train_lib.accumulate_gradients(
        wl.loss_fn(run.state.model), run.state.model, b2, seed=SEED, step=1,
        accum_steps=wl.accum_steps)
    sync(torch, dev)
    cuda.launches.clear()
    run.state, m2 = step(run.state, b2)
    sync(torch, dev)
    launches["on"] = dict(cuda.launches)
    got = {k: float(v) for k, v in m2.items() if k.startswith("dynamics/")}
    new = dict(run.state.model.named_parameters())
    plain = _plain_stats(torch, mods.flax_modules(wl.cfg), old, new, grads)
    err_plain = max(_rel_errs(got, plain).values())
    main = {f"dynamics/{stat}/{mod}": v
            for mod, stats in main_row["modules"].items()
            for stat, v in stats.items()
            if stat in ("grad_norm", "param_norm", "update_ratio")}
    main["dynamics/global_grad_norm"] = main_row["global_grad_norm"]
    err_main = max(_rel_errs(got, main).values())
    del old, grads, new
    if cuda_dev:
        # steps 3 and 4: off the cadence, then on it; then step 5 (its
        # first call) and step 6 without dynamics
        assert not dyn.on_cadence(run.state.step, 2) \
            and dyn.on_cadence(run.state.step + 1, 2)
        for key in ("off", "on"):
            kernels[key] = _count_kernels(
                torch, lambda: step(run.state, next(batches)))
        run.none(run.state, next(batches))
        kernels["none"] = _count_kernels(
            torch, lambda: run.none(run.state, next(batches)))
    row = {"phase": "planes_recompute", "rows": sorted(got),
           "max_rel_err_vs_plain": err_plain,
           "max_rel_err_vs_main_run": err_main, "tolerance": PLANES_TOL,
           "launches_off_cadence": launches["off"],
           "launches_on_cadence": launches["on"],
           "device_kernels": {k: v[0] for k, v in kernels.items()},
           "device_ms": {k: v[1] for k, v in kernels.items()}}
    emit(row)
    problems = []
    if err_plain > PLANES_TOL or err_main > PLANES_TOL:
        problems.append("the first row is off the plain recomputation")
    if cuda_dev:
        for key in ("off", "on"):
            _check_launches(f"planes_{key}", launches[key], 1,
                            TRAIN_LAUNCHES_PER_STEP)
        if kernels["off"][0] != kernels["none"][0]:
            problems.append(f"an off-cadence step ran {kernels['off'][0]} "
                            f"device kernels, a step without dynamics "
                            f"{kernels['none'][0]}")
    if problems:
        raise AssertionError(f"planes_recompute: {problems}")
    return launches


def _planes_timing(torch, device, run, rounds):
    """The median step ms of ``run.none`` and of ``run.step`` on and off
    the cadence (a call of k steps is on it when it holds a cadence step;
    its ms is divided by k), taking turns in rounds over one state after
    PLANES_WARM_ROUNDS untimed ones, and the peak memory of each."""
    from distributedtensorflow_tpu_torch.obs import dynamics as dyn

    dev = torch.device(device)
    cuda_dev = dev.type == "cuda"
    ms = {"none": [], "off": [], "on": []}
    peak = dict.fromkeys(ms, 0)
    for r in range(PLANES_WARM_ROUNDS + rounds):
        for step in (run.none, run.step, run.step):
            key = "none" if step is run.none else "on" if any(
                dyn.on_cadence(run.state.step + i, run.every)
                for i in range(run.k)) else "off"
            batch = next(run.batches)
            sync(torch, dev)
            if cuda_dev:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            run.state, m = step(run.state, batch)
            float(m["loss"][-1] if run.k > 1 else m["loss"])
            if r >= PLANES_WARM_ROUNDS:
                ms[key].append(1e3 * (time.perf_counter() - t0) / run.k)
                if cuda_dev:
                    peak[key] = max(peak[key],
                                    torch.cuda.max_memory_allocated())
    med = {key: statistics.median(v) if v else None for key, v in ms.items()}
    row = {"dynamics_every": run.every, "steps_per_call": run.k,
           "step_ms_none": med["none"], "step_ms_off_cadence": med["off"],
           "step_ms_on_cadence": med["on"],
           "calls": {key: len(v) for key, v in ms.items()},
           "peak_gib": ({key: v / 2**30 for key, v in peak.items()}
                        if cuda_dev else None)}
    if med["on"] is not None and med["off"] is not None:
        # a cadence call's extra, on its one cadence step
        row["cadence_extra_ms"] = run.k * (med["on"] - med["off"])
        row["off_cadence_vs_none_ms"] = med["off"] - med["none"]
    return row


def _planes_provenance(torch, cuda, mods, device, run, logdir):
    """NaN provenance at full width, as the JAX package's chaos drill
    runs it (``resilience/chaos.py`` ``nan_loss`` with a module): two
    steps of ``run.step`` under a DynamicsMonitor, then a NaN into block
    PLANES_POISON_LAYER's MLP weight in the live state at the step
    boundary, then the pass that a non-finite loss at that boundary
    runs.  It must name the block by its activation taps, and every
    module after it (each through K1f and K2) must count the NaN.  The
    pass's wall ms, its host syncs (``torch.cuda.set_sync_debug_mode``
    warnings) and its launches of the port's kernels.  It poisons the
    state, so it comes last."""
    import warnings

    from distributedtensorflow_tpu_torch import obs

    dev = torch.device(device)
    wl, model = run.wl, run.state.model
    layer = min(PLANES_POISON_LAYER, wl.cfg.num_layers - 1)
    mon = obs.DynamicsMonitor(run.every, logdir=logdir,
                              loss_fn=wl.loss_fn(model),
                              tap_fn=mods.make_nan_taps(model),
                              modules=mods.flax_modules(wl.cfg))
    step = mon.wrap_train_step(run.step)
    mon.on_fit_begin(None, run.state)
    for _ in range(2):
        run.state, m = step(run.state, next(run.batches))
        mon.on_step_end(None, run.state.step, run.state, m)
    with torch.no_grad():
        model.h[layer].fc_in.weight.fill_(float("nan"))
    sync(torch, dev)
    cuda.launches.clear()
    cuda_dev = dev.type == "cuda"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if cuda_dev:
            previous = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            doc = mon.maybe_provenance(run.state.step, "non_finite_loss")
            sync(torch, dev)
            ms = 1e3 * (time.perf_counter() - t0)
        finally:
            if cuda_dev:
                torch.cuda.set_sync_debug_mode(previous)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    launches = dict(cuda.launches)
    mon.close()
    want = f"h{layer}"
    after = [f"h{i}" for i in range(layer, wl.cfg.num_layers)] + ["ln_f"]
    counts = doc["nonfinite_activation_counts"] if doc else {}
    row = {"phase": "planes_provenance", "poisoned": f"h.{layer}.fc_in",
           "module": doc and doc["module"], "method": doc and doc["method"],
           "first_bad_param_module": doc and doc["first_bad_param_module"],
           "first_bad_grad_module": doc and doc["first_bad_grad_module"],
           "nonfinite_activation_counts": counts, "ms": ms,
           "host_syncs": syncs if cuda_dev else None,
           "launches": launches}
    emit(row)
    if not doc or doc["module"] != want \
            or doc["method"] != "activation_taps" \
            or any(not counts.get(m) for m in after) \
            or any(counts.get(f"h{i}") for i in range(layer)):
        raise AssertionError(f"planes_provenance: {row}")
    if cuda_dev and (not launches.get("layernorm_fwd")
                     or not launches.get("flash_fwd")):
        raise AssertionError(f"planes_provenance: the tap forward did not "
                             f"run K1f and K2: {launches}")
    return launches


def _planes_steps(torch, cuda, train_torch, train_lib, mods, device,
                  main_row, logdir):
    """Two builds of gpt_lm, each with a step without dynamics over the
    same state (:func:`_planes_run`).  At k = 1 and ``--dynamics-every
    2``: the recomputation and the kernel counts, the timing, then the
    provenance.  At k = 4 and every 8: the timing."""
    dev = torch.device(device)
    rows = []
    for k, every, rounds in PLANES_TIMING:
        run = _planes_run(train_torch, train_lib, mods, device, every, k)
        if k == 1:
            _planes_recompute(torch, cuda, train_lib, mods, device, run,
                              main_row)
        rows.append(_planes_timing(torch, device, run, rounds))
        if k == 1:
            _planes_provenance(torch, cuda, mods, device, run, logdir)
        del run
        gc.collect()
        empty_cache(torch, dev)
    emit({"phase": "planes_cost", "rows": rows})


def _webhook_receiver():
    """A loopback HTTP server on a thread that keeps every JSON body
    POSTed to it: ``(server, rows)``."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    rows = []

    class Hook(BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802 - http.server contract
            n = int(self.headers["Content-Length"])
            rows.append(json.loads(self.rfile.read(n)))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *args):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Hook)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, rows


def _planes_serve(torch, serve_torch, mods, config, device, tmp, smi):
    """``serve_torch.main`` on ``config`` (bf16, ``--max-context`` 2048)
    over the serve_cli mix at mode (a), with the planes off
    (``--history-interval 0``) and on (history every 0.5 s, the SLO
    rules, an alert rule set to fire and ``--alert-webhook`` at a
    loopback receiver): tokens/s and TPOT of each run; with the planes on
    the webhook gets the firing, ``/histz``, ``/sloz``, ``/alertz`` and
    ``/usagez`` answer, ``history.jsonl`` holds the tenants' pinned
    usage series and the logs pass the schema checker."""
    import os

    cfg = getattr(mods, config)()
    context = min(SERVE_CLI_CONTEXT, cfg.max_seq)
    prompts = _serve_cli_mix(cfg.vocab_size, SERVE_CLI_SCALE)
    new_tokens = SERVE_CLI_NEW_TOKENS
    rules = os.path.join(tmp, "fire.json")
    with open(rules, "w") as f:
        json.dump(PLANES_FIRE_RULES, f)
    receiver, hooked = _webhook_receiver()
    rows, problems = [], []
    try:
        for i, planes in enumerate(PLANES_SERVE_RUNS):
            logdir = os.path.join(tmp, f"serve_{i}_{planes}")
            argv = ["--config", config, "--device", device, "--port", "0",
                    "--dtype", "bfloat16", "--max-context", str(context),
                    "--seed", str(SEED), "--logdir", logdir]
            if planes == "on":
                argv += [
                    "--history-interval", PLANES_SERVE_INTERVAL,
                    "--slo-rules", PLANES_SLO_RULES,
                    "--slo-interval", PLANES_SERVE_INTERVAL,
                    "--alert-rules", rules, "--alert-interval",
                    PLANES_SERVE_INTERVAL, "--alert-webhook",
                    f"http://127.0.0.1:{receiver.server_address[1]}/hook"]
            else:
                argv += ["--history-interval", "0"]
            before = len(hooked)
            srv = _CliServer(serve_torch, argv)
            answers = {}
            try:
                replies, wall = _serve_mix(srv.port, prompts, new_tokens)
                if planes == "on":
                    deadline = time.time() + 10
                    while len(hooked) == before and time.time() < deadline:
                        time.sleep(0.1)
                    for path in ("/histz", "/sloz", "/alertz", "/usagez"):
                        answers[path] = _http(srv.port, path)[0]
            finally:
                rc = srv.close()
            tpot = [r["tpot_s"] for r in replies]
            ttft = [r["ttft_s"] for r in replies]
            row = {"phase": "planes_serve", "run": i, "planes": planes,
                   "config": config, "card": smi, "wall_s": wall,
                   "tokens_per_s": sum(len(r["tokens"])
                                       for r in replies) / wall,
                   "tpot_p50_s": float(np.percentile(tpot, 50)),
                   "ttft_p50_s": float(np.percentile(ttft, 50)),
                   "answers": answers,
                   "webhook_rows": [{k: h[k] for k in ("rule", "phase")}
                                    for h in hooked[before:]]}
            if rc != 0:
                problems.append(f"run {i}: serve_torch exited {rc}")
            if planes == "on":
                fired = [h for h in hooked[before:]
                         if h["rule"] == "ttft_high"
                         and h["phase"] == "fired"]
                history = open(os.path.join(logdir, "history.jsonl")).read()
                pinned = [f"serve_tenant_tokens_total.tenant_{t}"
                          for t in SERVE_CLI_TENANTS]
                files = [os.path.join(logdir, f) for f in (
                    "history.jsonl", "alerts.jsonl", "requests.jsonl",
                    "metrics.jsonl", "steps.jsonl", "usage.jsonl",
                    "metrics.prom")]
                rc_schema, out = _schema(files)
                row["schema_rc"] = rc_schema
                if not fired:
                    problems.append(f"run {i}: no firing reached the "
                                    f"webhook: {hooked[before:]}")
                if answers != dict.fromkeys(answers, 200) or len(answers) < 4:
                    problems.append(f"run {i}: endpoints {answers}")
                if any(name not in history for name in pinned):
                    problems.append(f"run {i}: history.jsonl lacks {pinned}")
                if rc_schema:
                    problems.append(f"run {i}: schema {out}")
            rows.append(row)
            emit(row)
            gc.collect()
            empty_cache(torch, torch.device(device))
    finally:
        receiver.shutdown()
        receiver.server_close()
    if problems:
        raise AssertionError(f"planes_serve: {problems}")
    return rows


def run_planes(torch, cuda, train_torch, serve_torch, mods, device="cuda",
               smi="", serve_config="gpt_small"):
    """The operations planes: (1) gpt_lm at full width through
    ``train_torch.main`` with ``--dynamics-every 2``, the status server,
    ``--fleet``, the example SLO and alert rules, 8 steps at k = 1 and
    k = 4: dynamics rows on steps 2, 4, 6, 8, equal at k = 4 and k = 1,
    /dynamicz /fleetz /sloz /alertz /histz answering, /healthz?deep=1
    failing exactly on the SLOs that the registry's gauges burn from the
    start (:func:`_burning_gauge_slos`), the logdirs passing the schema
    checker, run_report and doctor; the first row against a plain
    recomputation from a snapshot on the card; a step off the cadence
    launching what a step without dynamics launches.  (2) The step ms
    with and without dynamics, on and off the cadence, at k = 1 and
    k = 4.  (3) NaN provenance naming a poisoned block.  (4)
    serve_torch over HTTP with the planes off and on.  Returns the main
    path's launches: the two ``train_torch.main`` runs' and the serving
    runs'."""
    import os
    import shutil
    import tempfile

    from distributedtensorflow_tpu_torch import train as train_lib

    tmp = tempfile.mkdtemp(prefix="planes_")
    launches = collections.Counter()
    try:
        runs, problems = {}, []
        burning = _burning_gauge_slos(PLANES_SLO_RULES)
        for k in (1, 4):
            logdir = os.path.join(tmp, f"train_k{k}")
            records, got, answers, deep, secs = _planes_main(
                torch, cuda, train_torch, train_lib, logdir, k, device)
            launches.update(got)
            rows = _rows_of(os.path.join(logdir, "dynamics.jsonl"))
            files = [os.path.join(logdir, f) for f in (
                "dynamics.jsonl", "history.jsonl", "alerts.jsonl",
                "fleet.json", "metrics.jsonl", "metrics.prom")]
            rc_schema, out = _schema(files)
            tools = {name: subprocess.run(
                [sys.executable, f"tools/{name}.py", logdir],
                capture_output=True, text=True, timeout=120).returncode
                for name in ("run_report", "doctor")}
            runs[k] = rows
            emit({"phase": "planes_train", "k": k, "seconds": secs,
                  "steps": [r["step"] for r in rows],
                  "losses": [r["loss"] for r in records],
                  "answers": answers, "deep_health": deep,
                  "expected_fast_burning": burning, "schema_rc": rc_schema,
                  "tools_rc": tools, "launches": got,
                  "global_grad_norms": [r["global_grad_norm"]
                                        for r in rows]})
            if [r["step"] for r in rows] != list(
                    range(PLANES_EVERY, PLANES_STEPS + 1, PLANES_EVERY)):
                problems.append(f"k={k}: dynamics rows at "
                                f"{[r['step'] for r in rows]}")
            if sorted(answers) != sorted(PLANES_PATHS) or any(
                    answers[p] != 200 for p in PLANES_PATHS[:-1]):
                problems.append(f"k={k}: endpoints {answers}")
            problems += [f"k={k}: {p}" for p in _deep_health_problems(
                answers.get("/healthz?deep=1"), deep, burning)]
            if rc_schema or any(tools.values()):
                problems.append(f"k={k}: schema {rc_schema} {out} tools "
                                f"{tools}")
            if device == "cuda" and not got.get("layernorm_fwd"):
                problems.append(f"k={k}: no kernel launched: {got}")
        strip = [[{k: v for k, v in r.items() if k != "t"} for r in rows]
                 for rows in (runs[1], runs[4])]
        equal = strip[0] == strip[1]
        emit({"phase": "planes_k4_vs_k1", "rows_equal": equal})
        if not equal:
            problems.append("dynamics rows at k = 4 differ from k = 1")
        if problems:
            raise AssertionError(f"planes_train: {problems}")
        _planes_steps(torch, cuda, train_torch, train_lib, mods, device,
                      runs[1][0], os.path.join(tmp, "provenance"))
        sync(torch, torch.device(device))
        cuda.launches.clear()
        _planes_serve(torch, serve_torch, mods, serve_config, device, tmp,
                      smi)
        sync(torch, torch.device(device))
        launches.update(cuda.launches)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


#: The scaleout phase: gpt_lm's quantised steps (the train phase's
#: shape), its block GEMMs at a step's 16384 tokens, and the model=2 and
#: data=2 (ZeRO, overlap) steps in two processes over gloo on the card.
QUANT_STEPS = 3
#: The first (warm-up) loss of a quantised step against the full-width
#: one's on the same weights and batch, relative: int8 moves each product
#: by its rounding, up to 1/254 of a channel's absmax an operand.
QUANT_LOSS_RTOL = 2e-2
#: gpt_lm's block GEMMs (name, in, out) at QUANT_TOKENS tokens.
QUANT_GEMMS = (("qkv", 768, 2304), ("proj", 768, 768), ("fc_in", 768, 3072),
               ("fc_out", 3072, 768))
QUANT_TOKENS = 16384
#: fp8's accumulator against the exact (fp64) product of the same fp8
#: codes, of the product's max-abs: the tensor cores accumulate fp8
#: products at less than fp32's precision.
FP8_TOL = 2e-3
SCALE_STEPS = 1
#: model=2 against one process (loss relative, each gradient of its
#: max-abs): fp32 sums the ranks' partial products in another order; in
#: bf16 each rank rounds its partial products before the sum.
SCALE_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 1e-1)}
SCALE_DP_RUNS = (("plain", ()), ("zero", ("--zero",)),
                 ("overlap", ("--overlap",)))


def check_quant_gemms(torch, F):
    """gpt_lm's four block GEMMs at 16384 tokens (bf16 operands, the
    port's (out, in) weights): the int8 accumulator of
    ``torch._int_mm`` equals the exact product of the same codes (fp64),
    the fp8 accumulator of ``torch._scaled_mm`` is within FP8_TOL of it;
    each timed beside bf16 ``F.linear`` and the quantise pass."""
    from distributedtensorflow_tpu_torch.ops import quant as tq

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for name, k, n in QUANT_GEMMS:
        x = torch.randn(QUANT_TOKENS, k, device="cuda",
                        generator=gen).bfloat16()
        w = (torch.randn(n, k, device="cuda", generator=gen)
             / math.sqrt(k)).bfloat16()
        row = {"phase": "quant_gemm", "gemm": name, "m": QUANT_TOKENS,
               "k": k, "n": n,
               "bf16_ms": time_ms(torch, F.linear, [(x, w)])}
        for mode in ("int8", "fp8"):
            xq, _ = tq.quantize(x, mode=mode)
            wq, _ = tq.quantize(w, mode=mode)
            acc = tq.narrow_product(xq, wq)
            ref = xq.double() @ wq.double().T
            err = float((acc.double() - ref).abs().max())
            rel = err / float(ref.abs().max())
            ok = err == 0.0 if mode == "int8" else rel <= FP8_TOL
            nbytes = (QUANT_TOKENS * k + n * k) * 1 + QUANT_TOKENS * n * 4
            bound, by = bound_ms(nbytes, 2.0 * QUANT_TOKENS * n * k,
                                 xq.dtype)
            row[mode] = {
                "max_abs_err": err, "rel_err": rel, "ok": ok,
                "ms": time_ms(torch, tq.narrow_product, [(xq, wq)]),
                "quantize_ms": time_ms(
                    torch, lambda a, b, m=mode: (tq.quantize(a, mode=m),
                                                 tq.quantize(b, mode=m)),
                    [(x, w)]),
                "bound_ms": bound, "bound_by": by,
                "tolerance": "exact (the int32 accumulator against the "
                             "fp64 product of the codes)" if mode == "int8"
                             else f"{FP8_TOL} of the fp64 product's max-abs"}
            if not ok:
                emit(row)
                raise AssertionError(f"quant_gemm {name} {mode}: error "
                                     f"{err} ({rel} of max)")
        emit(row)
        rows.append(row)
        del x, w
    torch.cuda.empty_cache()
    return rows


#: The straight-through gradients of a QuantDense (bf16 operands) against
#: the fp64 products of the same operands, of each gradient's max-abs:
#: fp32 products rounded to bf16, whose unit roundoff is 2^-8.
STE_TOL = 4e-3


def check_quant_dense(torch):
    """One ``QuantDense`` a block GEMM of gpt_lm and a mode, on a (8,
    2048, in) bf16 input as the blocks give it: its forward (``int8_dot``
    through ``QuantMatmulFn``, the rescale by ``sx * sw``, the (B, S)
    layout) against the fp64 product of the same codes, rescaled in fp32
    and rounded to bf16 as the layer does, exactly for int8 and
    int8_stochastic (its uniforms drawn at the layer's site), within
    FP8_TOL plus bf16's rounding of the output for fp8; its gradients
    (the straight-through backward) against the fp64 products ``g w``
    and ``g^T x`` within STE_TOL."""
    from distributedtensorflow_tpu_torch.models.layers import QuantDense
    from distributedtensorflow_tpu_torch.ops import quant as tq

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    b = 8
    for name, k, n in QUANT_GEMMS:
        x = torch.randn(QUANT_TOKENS, k, device="cuda",
                        generator=gen).bfloat16()
        w = (torch.randn(n, k, device="cuda", generator=gen)
             / math.sqrt(k)).bfloat16()
        g = torch.randn(QUANT_TOKENS, n, device="cuda",
                        generator=gen).bfloat16()
        for mode in ("int8", "int8_stochastic", "fp8"):
            layer = QuantDense(k, n, dtype=torch.bfloat16, quant=mode,
                               device="cuda")
            layer.seed, layer.site = SEED, 3
            with torch.no_grad():
                layer.weight.copy_(w)
            x3 = x.reshape(b, -1, k).clone().requires_grad_()
            y = layer(x3)
            y.backward(g.reshape(b, -1, n))
            kx = kw = None
            if mode == "int8_stochastic":
                kx, kw = (SEED, 2 * layer.site), (SEED, 2 * layer.site + 1)
            xq, sx = tq.quantize(x, mode=mode, key=kx)
            wq, sw = tq.quantize(w, mode=mode, key=kw)
            acc = xq.double() @ wq.double().T
            y2 = y.detach().reshape(QUANT_TOKENS, n)
            if mode == "fp8":
                ref = acc * sx.double() * sw.double()[:, 0]
                err = float((y2.double() - ref).abs().max())
                rel = err / float(ref.abs().max())
                tol = FP8_TOL + 2.0 ** -8
                fwd_ok = rel <= tol
            else:
                want = (acc.float() * sx * sw[:, 0]).bfloat16()
                err = float((y2.float() - want.float()).abs().max())
                rel = err / float(want.float().abs().max())
                tol = 0.0
                fwd_ok = torch.equal(y2, want)
            grad_err = {}
            for gname, got, ref in (
                    ("dx", x3.grad.reshape(QUANT_TOKENS, k),
                     g.double() @ w.double()),
                    ("dw", layer.weight.grad, g.double().T @ x.double())):
                grad_err[gname] = float((got.double() - ref).abs().max()) \
                    / float(ref.abs().max())
            ok = fwd_ok and max(grad_err.values()) <= STE_TOL
            row = {"phase": "quant_dense", "gemm": name, "mode": mode,
                   "shape": [b, QUANT_TOKENS // b, k], "out": n,
                   "fwd_max_abs_err": err, "fwd_rel_err": rel,
                   "grad_rel_err": grad_err,
                   "ok": ok,
                   "tolerance": {
                       "forward": "exact (the fp64 product of the codes, "
                                  "rescaled in fp32, rounded to bf16)"
                                  if tol == 0.0 else
                                  f"{tol} of the fp64 product's max-abs",
                       "grads": f"{STE_TOL} of the fp64 product's "
                                "max-abs"}}
            emit(row)
            rows.append(row)
            if not ok:
                raise AssertionError(f"quant_dense {name} {mode}: forward "
                                     f"error {err}, gradients {grad_err}")
            del layer, x3, y
        del x, w, g
    torch.cuda.empty_cache()
    return rows


def run_quant_train(torch, cuda, train_torch, train_row):
    """gpt_lm as the train phase runs it at ``--quant int8`` and ``fp8``
    (1+3 steps: median ms, MFU on the bf16 rate, peak GiB, launches as the
    train phase's), the first loss within QUANT_LOSS_RTOL of the
    full-width one's, and one ``int8_stochastic`` step."""
    launches = collections.Counter()
    if train_row is None:  # the train phase did not run: none's steps here
        train_row = train_steps(torch, cuda, train_torch,
                                _train_args(train_torch), QUANT_STEPS,
                                "quant_none")[-1]
        torch.cuda.empty_cache()
    for mode in ("int8", "fp8"):
        state, _, _, got, row = train_steps(
            torch, cuda, train_torch,
            _train_args(train_torch, "--quant", mode), QUANT_STEPS,
            f"quant_{mode}")
        del state
        torch.cuda.empty_cache()
        _check_launches(row["phase"], got, QUANT_STEPS,
                        TRAIN_LAUNCHES_PER_STEP)
        launches.update(got)
        rel = abs(row["losses"][0] - train_row["losses"][0]) \
            / abs(train_row["losses"][0])
        row.update({"quant": mode, "first_loss_rel_to_none": rel,
                    "none_step_ms_median": train_row["step_ms_median"],
                    "none_mfu": train_row["mfu"],
                    "none_peak_mem_gib": train_row["peak_mem_gib"],
                    "tolerance": f"first loss {QUANT_LOSS_RTOL} relative "
                                 "to --quant none's"})
        emit(row)
        if rel > QUANT_LOSS_RTOL:
            raise AssertionError(f"quant_{mode}: first loss "
                                 f"{row['losses'][0]} vs none's "
                                 f"{train_row['losses'][0]}")
    _, state, step, batches = train_torch.build(
        _train_args(train_torch, "--quant", "int8_stochastic"))
    cuda.launches.clear()
    t0 = time.perf_counter()
    state, m = step(state, next(batches))
    loss = float(m["loss"])
    ms = 1e3 * (time.perf_counter() - t0)
    launches.update(cuda.launches)
    rel = abs(loss - train_row["losses"][0]) / abs(train_row["losses"][0])
    emit({"phase": "quant_int8_stochastic", "loss": loss,
          "first_step_ms": ms, "first_loss_rel_to_none": rel})
    del state, step, batches
    torch.cuda.empty_cache()
    if not math.isfinite(loss) or rel > QUANT_LOSS_RTOL:
        raise AssertionError(f"quant_int8_stochastic: loss {loss}")
    return launches


def _scale_args(train_torch, dtype, *extra):
    return _train_args(train_torch, "--dtype", dtype, "--dist-backend",
                       "gloo", *extra)


def _scale_run(torch, cuda, train_torch, dtype, *extra):
    """SCALE_STEPS steps of gpt_lm (DP_LAYERS layers, dropout 0) through
    ``train_torch.build``: the losses, the first step's gradients (this
    rank's shards, by name), the parameters after, the launches, the
    optimizer state's bytes (its tensors, and the allocator's growth over
    the first step, which makes the moments) and the split's shape."""
    before = torch.cuda.memory_allocated()
    with _cut_config(train_torch, num_layers=DP_LAYERS, dropout_rate=0.0):
        _, state, step, batches = train_torch.build(
            _scale_args(train_torch, dtype, *extra))
    built = torch.cuda.memory_allocated()
    grads = {}
    apply = state.apply_gradients

    def record(g):
        if not grads:
            grads.update({k: v.detach().cpu() for k, v in g.items()})
        return apply(g)

    state.apply_gradients = record
    cuda.launches.clear()
    losses, first = [], None
    for _ in range(SCALE_STEPS):
        state, m = step(state, next(batches))
        losses.append(float(m["loss"]))
        if first is None:
            torch.cuda.synchronize()
            first = torch.cuda.memory_allocated() - built
    torch.cuda.synchronize()
    attn = state.model.h[0].attn
    out = {"losses": losses, "grads": grads,
           "params": {n: p.detach().cpu()
                      for n, p in state.model.named_parameters()},
           "launches": dict(cuda.launches),
           "opt_state_bytes": sum(
               v.numel() * v.element_size()
               for st in state.optimizer.state.values()
               for v in st.values() if torch.is_tensor(v)),
           "alloc_first_step": first, "alloc_build": built - before,
           "heads": attn.n_heads, "vocab_rows": state.model.wte.weight.shape[0],
           "buckets": len(state.overlap.buckets) if state.overlap else 0,
           "coverage": state.overlap.coverage if state.overlap else 0.0}
    del state, step, batches
    torch.cuda.empty_cache()
    return out


def scaleout_worker(out_dir) -> int:
    """One rank of the scaleout phase's two (``--scaleout-worker``): the
    cluster from torchrun's variables, gloo, gpt_lm at DP_LAYERS layers
    through ``--mesh data=1,model=2`` in fp32 and bf16, then ``--mesh
    data=2`` plain, ``--zero`` and ``--overlap`` in fp32; saved as
    ``<out_dir>/rank<r>.pt``."""
    import torch

    import train_torch
    from distributedtensorflow_tpu_torch.ops import _cuda
    from distributedtensorflow_tpu_torch.parallel import bootstrap

    results = {}
    for dtype in ("float32", "bfloat16"):
        results["model2", dtype] = _scale_run(
            torch, _cuda, train_torch, dtype, "--mesh", "data=1,model=2")
    for name, flags in SCALE_DP_RUNS:
        results[name] = _scale_run(torch, _cuda, train_torch, "float32",
                                   "--mesh", "data=2", *flags)
    torch.save(results, f"{out_dir}/rank{bootstrap.process_index()}.pt")
    bootstrap.shutdown()
    return 0


def _grad_errs(got: dict, ref: dict) -> float:
    """The largest difference of a gradient over its max-abs."""
    return max(float((got[k] - v).abs().max()
                     / v.abs().max().clamp_min(1e-30)) for k, v in ref.items())


def run_scaleout(torch, cuda, train_torch, F, train_row):
    """(a) check_quant_gemms, check_quant_dense and run_quant_train; (b) model=2: two ranks
    on the one card over gloo (``--scaleout-worker`` processes), gpt_lm at
    full width cut to DP_LAYERS layers, in fp32 and bf16, against one
    process on the same batch (losses and every gradient, the shards put
    together), each rank on 6 of the 12 heads and its 25129 or 25128 of
    the 50257 vocab rows, launching the derived kernel counts; model=1
    over NCCL equals the train phase's losses bit for bit; (c) data=2 in
    the same processes, plain, ``--zero`` (losses beside the plain
    step's, each rank's optimizer state about half) and ``--overlap``
    (losses and parameters bit-equal to the plain step's).  No time of a
    gloo run is a scaling time: both ranks share one card, and their
    collectives go through the host."""
    from distributedtensorflow_tpu_torch.models.gpt import GPTLM, gpt_layout
    from distributedtensorflow_tpu_torch.parallel import bootstrap, sharding

    t0 = time.time()
    check_quant_gemms(torch, F)
    check_quant_dense(torch)
    launches = run_quant_train(torch, cuda, train_torch, train_row)
    emit({"phase": "scaleout_quant_seconds", "seconds": time.time() - t0})
    out_dir = "build/scaleout_check"
    os.makedirs(out_dir, exist_ok=True)
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(bootstrap.free_port()), "WORLD_SIZE": "2",
           "LOCAL_RANK": "0"}  # both ranks on the one card
    procs = [subprocess.Popen([sys.executable, __file__,
                               "--scaleout-worker", out_dir],
                              env={**env, "RANK": str(r)})
             for r in range(2)]
    try:
        refs = {dtype: _scale_run(torch, cuda, train_torch, dtype)
                for dtype in ("float32", "bfloat16")}
        # model=1 over NCCL: the tensor-parallel build of a world of one
        state, _, _, nccl_launches, row = train_steps(
            torch, cuda, train_torch, _train_args(
                train_torch, "--mesh", "data=1,model=1", "--dist-backend",
                "nccl"), 4, "scaleout_model1_nccl")
        del state
        bootstrap.shutdown()
        torch.cuda.empty_cache()
        _check_launches("scaleout_model1_nccl", nccl_launches, 4,
                        TRAIN_LAUNCHES_PER_STEP)
        launches.update(nccl_launches)
        if train_row is not None:
            row["train_losses"] = train_row["losses"]
            row["equal_to_train"] = row["losses"] == train_row["losses"]
        emit(row)
        if train_row is not None and not row["equal_to_train"]:
            raise AssertionError("scaleout_model1_nccl: losses differ from "
                                 "the train phase's")
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if rcs != [0, 0]:
        raise AssertionError(f"scaleout: the ranks exited with {rcs}")
    ranks = [torch.load(f"{out_dir}/rank{r}.pt") for r in range(2)]
    failures = []
    expected = _dp_launches("gpt_lm")
    with _cut_config(train_torch, num_layers=DP_LAYERS):
        cfg = train_torch.get_workload("gpt_lm").cfg
    rules = sharding.tp_rules(GPTLM(cfg, device="meta"), cfg, gpt_layout())
    for dtype, (loss_tol, grad_tol) in SCALE_TOL.items():
        got = [rk["model2", dtype] for rk in ranks]
        ref = refs[dtype]
        loss_err = max(abs(a - b) / abs(b) for g in got
                       for a, b in zip(g["losses"], ref["losses"]))
        grads = sharding.unshard_states([g["grads"] for g in got], rules)
        grad_err = _grad_errs(grads, ref["grads"])
        per_step = [{k: g["launches"].get(k, 0) / SCALE_STEPS
                     for k in expected} for g in got]
        ok = (loss_err <= loss_tol and grad_err <= grad_tol
              and per_step == [expected, expected]
              and [g["heads"] for g in got] == [cfg.num_heads // 2] * 2
              and sum(g["vocab_rows"] for g in got) == cfg.vocab_size)
        for g in got:
            launches.update(g["launches"])
        emit({"phase": "scaleout_model2", "dtype": dtype, "world": 2,
              "backend": "gloo", "mesh": "data=1,model=2",
              "layers": DP_LAYERS, "losses": got[0]["losses"],
              "ref_losses": ref["losses"], "loss_rel_err": loss_err,
              "grad_err": grad_err, "heads_per_rank": got[0]["heads"],
              "vocab_rows": [g["vocab_rows"] for g in got],
              "launches_per_step": per_step[0], "ok": ok,
              "tolerance": f"losses {loss_tol} relative, gradients "
                           f"{grad_tol} of each one's max-abs, against one "
                           "process on the same batch"})
        if not ok:
            failures.append(("model2", dtype))
    plain = [rk["plain"] for rk in ranks]
    for name, _ in SCALE_DP_RUNS[1:]:
        got = [rk[name] for rk in ranks]
        loss_err = max(abs(a - b) / abs(b) for g, p in zip(got, plain)
                       for a, b in zip(g["losses"], p["losses"]))
        param_err = max(_grad_errs(g["params"], p["params"])
                        for g, p in zip(got, plain))
        same = all(torch.equal(g["params"][k], p["params"][k])
                   for g, p in zip(got, plain) for k in p["params"])
        ratio = got[0]["opt_state_bytes"] / plain[0]["opt_state_bytes"]
        alloc_ratio = got[0]["alloc_first_step"] / max(
            plain[0]["alloc_first_step"], 1)
        if name == "zero":
            ok = loss_err <= 1e-5 and param_err <= 1e-5 \
                and 0.45 <= ratio <= 0.55
        else:
            ok = same and loss_err == 0.0 and got[0]["buckets"] > 1
        for g in got:
            launches.update(g["launches"])
        emit({"phase": f"scaleout_data2_{name}", "world": 2,
              "backend": "gloo", "layers": DP_LAYERS, "dtype": "float32",
              "losses": got[0]["losses"], "plain_losses": plain[0]["losses"],
              "loss_rel_err": loss_err, "param_err": param_err,
              "params_equal_plain": same,
              "opt_state_bytes": [g["opt_state_bytes"] for g in got],
              "plain_opt_state_bytes": plain[0]["opt_state_bytes"],
              "opt_state_ratio": ratio,
              "alloc_first_step": [g["alloc_first_step"] for g in got],
              "plain_alloc_first_step": plain[0]["alloc_first_step"],
              "alloc_first_step_ratio": alloc_ratio,
              "buckets": got[0]["buckets"], "coverage": got[0]["coverage"],
              "ok": ok,
              "tolerance": "losses and parameters 1e-5 of the plain step's "
                           "(relative; of each one's max-abs), optimizer "
                           "state 0.45-0.55 of it" if name == "zero" else
                           "losses and parameters bit-equal to the plain "
                           "step's"})
        if not ok:
            failures.append(name)
    emit({"phase": "scaleout_seconds", "seconds": time.time() - t0})
    if failures:
        raise AssertionError(f"scaleout: {failures} failed")
    return launches


#: The seqexpert phase: the flash kernels with a key-side segment array
#: at a packed ring chunk (B, S_loc, H, D); lm_long_context split over
#: seq=2 (ring and Ulysses, fp32 and bf16) and the MoE presets over
#: expert=2, each in two processes over gloo on the one card, against one
#: process on the same batch; a world of one over NCCL.
KVSEG_SHAPE = (4, 1024, 12, 64)
SEQEX_LAYERS = 2
SEQ_RUNS = tuple((scheme, dtype) for scheme in ("ring", "ulysses")
                 for dtype in ("float32", "bfloat16"))
#: (preset, global batch, capacity factor or None for the preset's): the
#: MoE runs at expert=2 in fp32; at 8.0, both presets' n_experts, no token
#: is dropped and the split run also equals the unsplit one.
EP_RUNS = (("gpt_moe", 8, None), ("gpt_moe", 8, 8.0), ("bert_moe", 16, None),
           ("bert_moe", 16, 8.0))
#: The split run against the one-process run that routes the same token
#: shards (relative loss, each gradient of its max-abs), by dtype; the
#: aux loss of an unsplit run only roughly (a mean of the shards'
#: load-balance estimates is not the whole batch's, as JAX's
#: ``tests/test_moe.py:125-133`` notes).
SEQEX_TOL = SCALE_TOL
EP_AUX_RTOL = 0.2
SEQEX_NOTE = ("two processes on one card over gloo (collectives through "
              "the host): no time here is a scaling time")


def check_flash_kv_segments(torch, fa):
    """K2, K3f and the K3 pair with ``kv_segment_ids`` at a packed ring
    chunk (KVSEG_SHAPE), in bf16 and fp32: the queries hold the second
    half of packed rows of 2 S_loc tokens, the keys either the first half
    (a past chunk of the ring: not causal, the segments cross the chunk
    boundary) or the same half passed as a second array (the diagonal
    chunk, causal; its key segments are the queries' with the first
    boundary of each row moved 7 tokens later, so that a kernel reading
    the query array for the keys disagrees).  Each against its plain twin
    at check_flash's tolerances, and timed beside the same call with one
    array (the kernels' path without the key-side array), its plain twin
    and SDPA with the segment mask (the forward beside K2, the eager
    backward beside K3f and the K3 pair), alone on the card."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 19)
    b, s, h, d = KVSEG_SHAPE
    seg = torch.cumsum(torch.rand((b, 2 * s), device="cuda", generator=g)
                       < 0.004, 1).to(torch.int32)
    qseg = seg[:, s:].contiguous()
    dseg = qseg.clone()
    for r in range(b):
        later = (dseg[r] != dseg[r, 0]).nonzero()
        if len(later):
            cut = int(later[0])
            dseg[r, cut:cut + 7] = dseg[r, 0]
    if torch.equal(dseg, qseg):
        raise AssertionError("kv_segments: the diagonal case's key segments "
                             "equal the queries'")
    rows = {k: [] for k in FLASH_ROWS}
    for dtype in (torch.bfloat16, torch.float32):
        def rnd():
            return torch.randn(b, s, h, d, device="cuda",
                               generator=g).to(dtype)

        q, k, v, do = rnd(), rnd(), rnd(), rnd()
        for case, causal, kseg in (("past_chunk", False,
                                    seg[:, :s].contiguous()),
                                   ("diagonal", True, dseg)):
            kw = dict(mask=None, segment_ids=qseg, causal=causal,
                      window=None, kv_segment_ids=kseg)
            one = dict(kw, kv_segment_ids=None)
            o, lse = fa.flash_forward_cuda(q, k, v, **kw)
            ro, rlse = fa._plain_flash_forward(q, k, v, **kw)
            delta = (do.float() * ro.float()).sum(-1).transpose(1, 2) \
                .contiguous()
            bargs = (q, k, v, do, rlse, delta)
            got = {"flash_bwd_dq": (fa.flash_bwd_dq_cuda(*bargs, **kw),),
                   "flash_bwd_dkv": fa.flash_bwd_dkv_cuda(*bargs, **kw),
                   "flash_bwd_fused": fa.flash_bwd_fused_cuda(*bargs, **kw)}
            torch.cuda.synchronize()
            ref = {"flash_bwd_dq": (fa._plain_flash_bwd_dq(*bargs, **kw),),
                   "flash_bwd_dkv": fa._plain_flash_bwd_dkv(*bargs, **kw),
                   "flash_bwd_fused": fa._plain_flash_bwd_fused(*bargs,
                                                                **kw)}
            o_tol, g_tol = (2e-2, 1e-2) if dtype == torch.bfloat16 \
                else (2e-5, 1e-4)
            keep = qseg[:, None, :, None] == kseg[:, None, None, :]
            if causal:
                keep = keep & torch.ones(s, s, dtype=torch.bool,
                                         device="cuda").tril()
            pairs = float(keep.sum()) * h
            el = q.element_size()
            qbytes, rows_bytes = b * s * h * d * el, b * h * s * 4
            specs = [
                ("flash_fwd", fa.flash_forward_cuda, fa._plain_flash_forward,
                 (q, k, v), 4 * d * pairs, 4 * qbytes + rows_bytes,
                 max((o.float() - ro.float()).abs().max().item(),
                     (lse - rlse).abs().max().item()),
                 (o.float() - ro.float()).abs().max().item() <= o_tol
                 and (lse - rlse).abs().max().item() <= 1e-3),
            ]
            for name, n_ops, n_io in (("flash_bwd_dq", 6, 5),
                                      ("flash_bwd_dkv", 8, 6),
                                      ("flash_bwd_fused", 10, 7)):
                errs = [_rel_err(a, r) for a, r in zip(got[name], ref[name])]
                specs.append((name, getattr(fa, f"{name}_cuda"),
                              getattr(fa, f"_plain_{name}"), bargs,
                              n_ops * d * pairs,
                              n_io * qbytes + 2 * rows_bytes,
                              max((a.float() - r.float()).abs().max().item()
                                  for a, r in zip(got[name], ref[name])),
                              max(errs) <= g_tol))
            del got, ref
            lib_mask = keep
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib_ms = time_ms(torch, lambda: torch.nn.functional
                             .scaled_dot_product_attention(
                                 qt, kt, vt, attn_mask=lib_mask), [()],
                             iters=10, reps=3)
            # the library's backward with the same mask, eager (the
            # autograd call does not capture in a graph), beside K3f and
            # the K3 pair
            qr, kr, vr = (x.detach().clone().requires_grad_(True)
                          for x in (qt, kt, vt))
            out_lib = torch.nn.functional.scaled_dot_product_attention(
                qr, kr, vr, attn_mask=lib_mask)
            dot = do.transpose(1, 2)
            lib_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
                out_lib, (qr, kr, vr), dot, retain_graph=True), [()],
                graph=False, iters=10, reps=3)
            del out_lib, qr, kr, vr
            for name, kern, plain, args, flops, nbytes, err, ok in specs:
                bms, by = bound_ms(nbytes, flops, dtype)
                row = {"kernel": name, "case": f"kv_segments_{case}",
                       "b": b, "s": s, "h": h, "d": d,
                       "dtype": str(dtype)[6:], "causal": causal,
                       "segments": True, "kv_segments": True,
                       "variant": fa.kernel_variant(dtype, name),
                       "max_abs_err": err, "ok": ok,
                       "tolerance": (f"o atol {o_tol}, lse atol 1e-3"
                                     if name == "flash_fwd" else
                                     f"{g_tol} of each output's max-abs"),
                       "flops": flops,
                       "ms": time_ms(torch, functools.partial(kern, **kw),
                                     [args], iters=10, reps=3),
                       "same_array_ms": time_ms(
                           torch, functools.partial(kern, **one), [args],
                           iters=10, reps=3),
                       "plain_ms": time_ms(torch,
                                           functools.partial(plain, **kw),
                                           [args], iters=2, reps=3),
                       "library_ms": lib_ms if name == "flash_fwd"
                       else lib_bwd_ms,
                       "library": "F.scaled_dot_product_attention "
                                  + ("forward" if name == "flash_fwd" else
                                     "backward (eager autograd.grad)")
                                  + " with the segment mask",
                       "bound_ms": bms, "bound_by": by}
                emit(row)
                if not ok:
                    raise AssertionError(f"{name} with kv_segment_ids "
                                         f"disagrees: {row}")
                rows[name].append(row)
            del keep, lib_mask
            torch.cuda.empty_cache()
    return rows


def _shard_routed(local_moe, expert_fn, cfg, n, tokens, router, experts,
                  token_mask=None):
    """The expert-parallel region's routing in one process: the tokens in
    ``n`` shards, each routed alone with its own capacity
    (``parallel.moe.local_moe``), the aux loss the shards' mean."""
    outs, auxes = [], []
    masks = [None] * n if token_mask is None else token_mask.chunk(n)
    for chunk, mask in zip(tokens.chunk(n), masks):
        out, aux = local_moe(chunk, router, experts, expert_fn,
                             capacity_factor=cfg.capacity_factor,
                             router=cfg.router, token_mask=mask)
        outs.append(out)
        auxes.append(aux)
    import torch

    return torch.cat(outs), sum(auxes) / n


def _seqex_argv(kind, *extra):
    """train_torch's flags of a seqexpert run: ``kind`` ("seq", dtype) or
    (preset, batch, capacity factor)."""
    common = ["--seed", str(SEED), "--device", "cuda", *extra]
    if kind[0] == "seq":
        return ["--workload", "lm_long_context", "--batch-size", "2",
                "--dtype", kind[1], *common]
    return ["--workload", kind[0], "--batch-size", str(kind[1]),
            "--accum-steps", "1", "--dtype", "float32", *common]


def _seqex_step(torch, cuda, train_torch, kind, extra=(), shards=0):
    """One step of a seqexpert run through ``train_torch.build`` at
    SEQEX_LAYERS layers, dropout 0: its loss and metrics, the step's
    gradients (this rank's, by name, on the CPU), the launches and the
    step's seconds.  ``shards``: route the MoE layers' tokens in that many
    shards in one process (:func:`_shard_routed`)."""
    import functools

    from distributedtensorflow_tpu_torch.models.gpt_moe import (
        MoEMLP,
        _expert_mlp,
    )
    from distributedtensorflow_tpu_torch.parallel.moe import local_moe

    fields = {"num_layers": SEQEX_LAYERS, "dropout_rate": 0.0}
    if kind[0] != "seq" and kind[2] is not None:
        fields["capacity_factor"] = kind[2]
    with _cut_config(train_torch, **fields):
        _, state, step, batches = train_torch.build(
            train_torch.parse_args(_seqex_argv(kind, *extra)))
    if shards:
        for mod in state.model.modules():
            if isinstance(mod, MoEMLP):
                mod.moe_fn = functools.partial(_shard_routed, local_moe,
                                               _expert_mlp, mod.cfg, shards)
    grads = {}
    apply = state.apply_gradients

    def record(g):
        grads.update({k: v.detach().float().cpu() for k, v in g.items()})
        return apply(g)

    state.apply_gradients = record
    batch = next(batches)
    torch.cuda.synchronize()
    cuda.launches.clear()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    out = {"seconds": time.perf_counter() - t0,
           "metrics": {k: float(v) for k, v in m.items()},
           "grads": grads, "launches": dict(cuda.launches),
           "experts": next((p.shape[0] for n, p in
                            state.model.named_parameters()
                            if n.endswith("experts_in")), None)}
    del state, step, batches
    torch.cuda.empty_cache()
    return out


def _seqex_refs(kind):
    """The one-process references a split run is held against: name ->
    (kind, shards)."""
    if kind[0] == "seq":
        return {"ref": (kind, 0)}
    refs = {"ref": (kind, 2)}
    if kind[2] is not None:
        refs["unsplit"] = (kind, 0)
    return refs


def _ref_path(out_dir, kind, ref):
    return f"{out_dir}/ref_{'_'.join(map(str, kind))}_{ref}.pt"


def _seqex_kinds():
    return [("seq", dtype) for dtype in ("float32", "bfloat16")] + \
        list(EP_RUNS)


#: Gradients left out of the comparisons, reported apart: a BERT key
#: bias adds one constant to a query's scores, so its gradient is 0 but
#: for rounding noise on both sides (``tests/test_torch_sharding.py``
#: leaves it out too).
SEQEX_NOISE = ("attention.key.bias",)


def _seqex_compare(torch, got, ref, rank, n):
    """Loss (relative) and gradient (of each one's max-abs) errors of a
    rank's run against a one-process one; the expert stacks against the
    rank's 1/n of the reference's; SEQEX_NOISE's apart."""
    loss = got["metrics"]["loss"]
    rloss = ref["metrics"]["loss"]
    errs, noise = {}, {}
    for k, v in ref["grads"].items():
        g = got["grads"][k]
        if g.shape != v.shape:
            v = v.chunk(n)[rank]
        err = float((g - v).abs().max() / v.abs().max().clamp_min(1e-30))
        (noise if k.endswith(SEQEX_NOISE) else errs)[k] = err
    return {"loss": loss, "ref_loss": rloss,
            "loss_rel_err": abs(loss - rloss) / abs(rloss),
            "grad_err": max(errs.values()),
            "worst_grad": max(errs, key=errs.get),
            "noise_grad_err": max(noise.values(), default=None)}


def _seqex_results(torch, out_dir) -> dict:
    """A split worker's rank of the seqexpert phase: lm_long_context
    through ``--mesh data=1,seq=2`` for each SEQ_RUNS scheme and dtype,
    then each EP_RUNS preset through ``--mesh data=1,expert=2``; each held
    against the main process's one-process references (read from
    ``out_dir`` once they are there): the comparisons and the launches."""
    import train_torch
    from distributedtensorflow_tpu_torch.ops import _cuda
    from distributedtensorflow_tpu_torch.parallel import bootstrap

    runs = [(("seq", dtype), ("--mesh", "data=1,seq=2", "--sp-scheme",
                              scheme, "--dist-backend", "gloo"), scheme)
            for scheme, dtype in SEQ_RUNS]
    runs += [(kind, ("--mesh", "data=1,expert=2", "--dist-backend",
                     "gloo"), None) for kind in EP_RUNS]
    results = {}
    for kind, flags, scheme in runs:
        got = _seqex_step(torch, _cuda, train_torch, kind, flags)
        rank = bootstrap.process_index()
        deadline = time.time() + 600
        while not os.path.exists(f"{out_dir}/refs.done"):
            if time.time() > deadline:
                raise TimeoutError("seqexpert: no references")
            time.sleep(0.5)
        row = {"launches": got["launches"], "seconds": got["seconds"],
               "metrics": got["metrics"], "experts": got["experts"]}
        for ref_name in _seqex_refs(kind):
            ref = torch.load(_ref_path(out_dir, kind, ref_name))
            row[ref_name] = _seqex_compare(torch, got, ref, rank, 2)
            row[ref_name]["ref_metrics"] = ref["metrics"]
            del ref
        results[kind + ((scheme,) if scheme else ())] = row
    return results


#: The phases whose ranks run in the two split workers, in their order,
#: and each one's directory: its references, marker and result files.
SPLIT_DIRS = {"seqexpert": "build/seqexpert_check",
              "pipeline": "build/pipeline_check",
              "splitckpt": "build/splitckpt_check",
              "splitzero": "build/splitzero_check"}


def split_worker(phases) -> int:
    """One rank of the two split workers (``--split-worker``): the
    cluster from torchrun's variables, gloo (each run's ``train_torch``
    flags); each phase of ``phases`` (comma-separated, of SPLIT_DIRS) in
    turn, its results saved as ``<its dir>/rank<r>.pt`` as it ends:
    written aside, then renamed, since the main process waits for the
    file."""
    import torch

    from distributedtensorflow_tpu_torch.parallel import bootstrap

    run = {"seqexpert": _seqex_results, "pipeline": _pipe_results,
           "splitckpt": _splitck_results, "splitzero": _splitz_results}
    for phase in phases.split(","):
        results = run[phase](torch, SPLIT_DIRS[phase])
        path = f"{SPLIT_DIRS[phase]}/rank{bootstrap.process_index()}.pt"
        torch.save(results, path + ".part")
        os.replace(path + ".part", path)
    bootstrap.shutdown()
    return 0


def _start_split_workers(phases):
    """The two split workers for ``phases`` (a list of SPLIT_DIRS' keys),
    both ranks on the one card (``LOCAL_RANK`` 0), each phase's
    directory emptied first."""
    from distributedtensorflow_tpu_torch.parallel import bootstrap

    for phase in phases:
        shutil.rmtree(SPLIT_DIRS[phase], ignore_errors=True)
        os.makedirs(SPLIT_DIRS[phase])
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(bootstrap.free_port()), "WORLD_SIZE": "2",
           "LOCAL_RANK": "0"}
    return [subprocess.Popen([sys.executable, __file__, "--split-worker",
                              ",".join(phases)], env={**env, "RANK": str(r)})
            for r in range(2)]


def _wait_files(paths, workers, what, timeout=900) -> None:
    """Wait for every one of ``paths``, which the split ``workers`` write;
    fails when a worker exits with an error, or both exit without them,
    or the time runs out."""
    deadline = time.time() + timeout
    while not all(os.path.exists(p) for p in paths):
        codes = [p.poll() for p in workers]
        if any(codes) or None not in codes or time.time() > deadline:
            raise AssertionError(f"{what}: the workers exited with {codes} "
                                 f"before writing {paths}")
        time.sleep(0.5)


def _split_results(torch, workers, phase, timeout=900) -> list:
    """Each rank's results of ``phase``, once both files are there (the
    directory then removed; :func:`_wait_files`)."""
    paths = [f"{SPLIT_DIRS[phase]}/rank{r}.pt" for r in range(2)]
    _wait_files(paths, workers, phase, timeout)
    ranks = [torch.load(p) for p in paths]
    shutil.rmtree(SPLIT_DIRS[phase], ignore_errors=True)
    return ranks


def _seq_launches(scheme, rank):
    """Launches per step of a ``seq`` rank of lm_long_context at
    SEQEX_LAYERS layers: a causal ring rank r computes r + 1 chunks a
    layer (its own diagonal one and the r before it: the later ones are
    skipped), Ulysses one whole-sequence attention; the flash forward
    twice (attention-only remat recomputes it), K3f once (S_loc D 4 and S
    D 4 fit the 2 MiB threshold); the LayerNorms and the head as one
    process's."""
    n = SEQEX_LAYERS
    chunks = rank + 1 if scheme == "ring" else 1
    return {"flash_fwd": 2 * n * chunks, "flash_bwd_fused": n * chunks,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "layernorm_fwd": 2 * n + 1, "layernorm_bwd": 2 * n + 1,
            "fused_xent_fwd": 1, "fused_xent_dx": 1, "fused_xent_dw": 1}


def _seqex_write_refs(torch, cuda, train_torch, out_dir):
    """Every one-process reference of the workers' runs into ``out_dir``,
    then the ``refs.done`` marker that the workers wait for."""
    for kind in _seqex_kinds():
        for ref_name, (rkind, shards) in _seqex_refs(kind).items():
            ref = _seqex_step(torch, cuda, train_torch, rkind, shards=shards)
            torch.save(ref, _ref_path(out_dir, kind, ref_name))
            del ref
    with open(f"{out_dir}/refs.done", "w") as f:
        f.write("ok\n")


def _ep_launches(name):
    """Launches per step and rank of an EP_RUNS preset at SEQEX_LAYERS
    layers: gpt_moe's as gpt_lm's (``_dp_launches``); bert_moe (one
    microbatch, no remat, seq 512 below the flash gate) 2L + 2 LayerNorms
    once each way, no flash and no fused head."""
    if name == "gpt_moe":
        return _dp_launches("gpt_moe")
    n = SEQEX_LAYERS
    return {**NO_LAUNCHES, "layernorm_fwd": 2 * n + 2,
            "layernorm_bwd": 2 * n + 2}


def _seqex_report(ranks) -> tuple:
    """The rows of the workers' results (``ranks``: each rank's saved
    dict): ``(launches, failures)``.  A run of SEQ_RUNS or EP_RUNS that a
    rank did not report is a failure."""
    launches = collections.Counter()
    want_keys = {("seq", dtype, scheme) for scheme, dtype in SEQ_RUNS} \
        | set(EP_RUNS)
    failures = [("missing", r, sorted(map(str, want_keys - set(rk))))
                for r, rk in enumerate(ranks) if want_keys - set(rk)]
    if failures:
        return launches, failures
    for scheme, dtype in SEQ_RUNS:
        loss_tol, grad_tol = SEQEX_TOL[dtype]
        got = [rk[("seq", dtype, scheme)] for rk in ranks]
        flash = ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq",
                 "flash_bwd_dkv")
        want = [_seq_launches(scheme, r) for r in range(2)]
        per_rank = [{k: g["launches"].get(k, 0) for k in want[0]}
                    for g in got]
        ok = (all(g["ref"]["loss_rel_err"] <= loss_tol
                  and g["ref"]["grad_err"] <= grad_tol for g in got)
              and per_rank == want)
        for g in got:
            launches.update(g["launches"])
        emit({"phase": "seqexpert_seq", "scheme": scheme, "dtype": dtype,
              "workload": "lm_long_context", "mesh": "data=1,seq=2",
              "world": 2, "backend": "gloo", "layers": SEQEX_LAYERS,
              "loss": [g["ref"]["loss"] for g in got],
              "ref_loss": got[0]["ref"]["ref_loss"],
              "loss_rel_err": [g["ref"]["loss_rel_err"] for g in got],
              "grad_err": [g["ref"]["grad_err"] for g in got],
              "worst_grad": [g["ref"]["worst_grad"] for g in got],
              "flash_launches": [{k: p[k] for k in flash} for p in per_rank],
              "expected_flash_launches": [{k: w[k] for k in flash}
                                          for w in want],
              "launches_per_rank": per_rank,
              "step_s": [g["seconds"] for g in got], "note": SEQEX_NOTE,
              "ok": ok,
              "tolerance": f"loss {loss_tol} relative, gradients "
                           f"{grad_tol} of each one's max-abs, against one "
                           "process on the same batch; launches as "
                           "derived from n = 2"})
        if not ok:
            failures.append(("seq", scheme, dtype))
    for kind in EP_RUNS:
        name, batch, cf = kind
        got = [rk[kind] for rk in ranks]
        ok = all(g["ref"]["loss_rel_err"] <= SEQEX_TOL["float32"][0]
                 and g["ref"]["grad_err"] <= SEQEX_TOL["float32"][1]
                 for g in got)
        extra = {}
        if cf is not None:
            # no drops: the LM loss (log perplexity for gpt_moe; bert_moe's
            # loss, whose expert-choice aux is 0, and every gradient)
            # equals the unsplit run's; top-2's aux only roughly
            u = [g["unsplit"] for g in got]
            if name == "gpt_moe":
                lm = [math.log(g["metrics"]["perplexity"]) for g in got]
                ulm = math.log(u[0]["ref_metrics"]["perplexity"])
                aux = [g["metrics"]["aux_loss"] for g in got]
                uaux = u[0]["ref_metrics"]["aux_loss"]
                extra = {"lm_loss": lm, "unsplit_lm_loss": ulm,
                         "aux_loss": aux, "unsplit_aux_loss": uaux}
                ok = ok and all(abs(a - ulm) <= 1e-5 * abs(ulm) for a in lm) \
                    and all(abs(a - uaux) <= EP_AUX_RTOL * abs(uaux)
                            for a in aux)
            else:
                extra = {"unsplit_loss_rel_err":
                         [x["loss_rel_err"] for x in u],
                         "unsplit_grad_err": [x["grad_err"] for x in u],
                         "unsplit_worst_grad": [x["worst_grad"] for x in u],
                         "unsplit_key_bias_grad_err":
                         [x["noise_grad_err"] for x in u]}
                ok = ok and all(x["loss_rel_err"] <= 1e-5
                                and x["grad_err"] <= 1e-4 for x in u)
        want = _ep_launches(name)
        ok = ok and all({k: g["launches"].get(k, 0) for k in want}
                        == want for g in got)
        for g in got:
            launches.update(g["launches"])
        emit({"phase": "seqexpert_expert", "workload": name,
              "mesh": "data=1,expert=2", "world": 2, "backend": "gloo",
              "layers": SEQEX_LAYERS, "batch": batch, "dtype": "float32",
              "capacity_factor": cf,
              "experts_per_rank": [g["experts"] for g in got],
              "loss": [g["ref"]["loss"] for g in got],
              "ref_loss": got[0]["ref"]["ref_loss"],
              "loss_rel_err": [g["ref"]["loss_rel_err"] for g in got],
              "grad_err": [g["ref"]["grad_err"] for g in got],
              "worst_grad": [g["ref"]["worst_grad"] for g in got],
              "key_bias_grad_err": [g["ref"]["noise_grad_err"]
                                    for g in got],
              **extra, "launches_per_rank": [g["launches"] for g in got],
              "expected_launches": want,
              "step_s": [g["seconds"] for g in got], "note": SEQEX_NOTE,
              "ok": ok,
              "tolerance": "loss 1e-5 relative, gradients 1e-4 of each "
                           "one's max-abs (a key bias's, rounding noise, "
                           "apart), against one process routing the same "
                           "two token shards; launches as derived" + (
                               "; at capacity factor 8 the LM loss 1e-5 of "
                               f"the unsplit run's, its aux {EP_AUX_RTOL} "
                               "relative (expert choice: loss and every "
                               "gradient)" if cf else "")})
        if not ok:
            failures.append(kind)
    return launches, failures


def run_seqexpert(torch, cuda, train_torch, train_row, workers):
    """lm_long_context at full width (768, 12 heads, S 8192, batch 2) cut
    to SEQEX_LAYERS layers over seq=2, ring and Ulysses, fp32 and bf16,
    and gpt_moe (8 experts, top-2, seq 2048) and bert_moe (8 experts,
    expert choice, seq 512) cut to SEQEX_LAYERS layers over expert=2 (4
    of 8 experts a rank): the ranks are the split ``workers`` over gloo
    on the one card, held against one process on the same batch (the
    loss, every gradient; the MoE presets against one process that routes
    the same two token shards, and at capacity factor 8 also against the
    unsplit one), each rank's K2/K3f/K3 launches against the counts
    derived from n = 2.  Then ``--mesh data=1,seq=1,expert=1`` over NCCL,
    the train phase's losses bit for bit (at seq=1,expert=1 the step
    takes the plain path: this checks only that the mesh's seq and expert
    groups build over NCCL).  The references (:func:`_seqex_write_refs`)
    come first, while the workers start and run."""
    from distributedtensorflow_tpu_torch.parallel import bootstrap

    t0 = time.time()
    _seqex_write_refs(torch, cuda, train_torch, SPLIT_DIRS["seqexpert"])
    emit({"phase": "seqexpert_refs_seconds", "seconds": time.time() - t0})
    state, _, _, launches, row = train_steps(
        torch, cuda, train_torch, _train_args(
            train_torch, "--mesh", "data=1,seq=1,expert=1",
            "--dist-backend", "nccl"), 4, "seqexpert_world1_nccl")
    del state
    bootstrap.shutdown()
    torch.cuda.empty_cache()
    _check_launches("seqexpert_world1_nccl", launches, 4,
                    TRAIN_LAUNCHES_PER_STEP)
    if train_row is not None:
        row["train_losses"] = train_row["losses"]
        row["equal_to_train"] = row["losses"] == train_row["losses"]
    emit(row)
    if train_row is not None and not row["equal_to_train"]:
        raise AssertionError("seqexpert_world1_nccl: losses differ from "
                             "the train phase's")
    ranks = _split_results(torch, workers, "seqexpert")
    worker_launches, failures = _seqex_report(ranks)
    launches = collections.Counter(launches)
    launches.update(worker_launches)
    emit({"phase": "seqexpert_seconds", "seconds": time.time() - t0})
    if failures:
        raise AssertionError(f"seqexpert: {failures} failed")
    return launches


#: The pipeline phase: gpt_lm at full width (768, 12 heads, vocab 50257,
#: S 2048, block remat) cut to PIPE_LAYERS layers (``--pp-virtual 2``
#: then holds one layer a chunk), global batch PIPE_BATCH (8 microbatches
#: by the preset's rule at pipe=2), ``--mesh data=1,pipe=2`` in two
#: processes over gloo on the one card, each schedule of PIPE_RUNS in fp32
#: and bf16 against one process's dense GPTLM on the same weights (the
#: chunked head both ways), and the bf16 wire of PIPE_WIRE_RUNS against
#: the fp32 wire bit for bit.
PIPE_LAYERS = 4
PIPE_BATCH = 8
PIPE_MICRO = 8
PIPE_RUNS = (("gpipe", 1), ("gpipe", 2), ("1f1b", 1), ("interleaved", 2))
PIPE_WIRE_RUNS = (("gpipe", 1), ("interleaved", 2))
#: Against the dense model (relative loss, each gradient of its max-abs),
#: by dtype: the scaleout and seqexpert phases' (SCALE_TOL); a schedule
#: against GPipe in fp32 as well.
PIPE_TOL = SCALE_TOL
PIPE_NOTE = ("two processes on one card over gloo (handoffs through the "
             "host); no NCCL handoff across cards is exercised: no time "
             "here is a scaling time")


def _pipe_argv(schedule, v, dtype, wire="fp32", mesh=True):
    """train_torch's flags of a pipeline run (``mesh=False``: the dense
    reference), the chunked head both ways."""
    argv = ["--workload", "gpt_lm", "--batch-size", str(PIPE_BATCH),
            "--seq-len", "2048", "--remat", "on", "--xent-impl", "chunked",
            "--dtype", dtype, "--seed", str(SEED), "--device", "cuda"]
    if mesh:
        argv += ["--mesh", "data=1,pipe=2", "--dist-backend", "gloo",
                 "--pipeline-schedule", schedule, "--pp-virtual", str(v),
                 "--pp-handoff-dtype", wire]
    return argv


#: The dense seeded state of a pipeline run's config (every run of a
#: process draws the same one; each rank keeps its stage's entries)
_PIPE_INIT: dict = {}


@contextlib.contextmanager
def _pipe_preset(train_torch):
    """``train_torch.build`` of gpt_lm at PIPE_LAYERS layers, its seeded
    state drawn once a process (:data:`_PIPE_INIT`), inside the block."""
    make = train_torch.get_workload

    def cached_init(init):
        def init_params(cfg, generator):
            key = (cfg.num_layers, generator.initial_seed())
            if key not in _PIPE_INIT:
                _PIPE_INIT[key] = init(cfg, generator)
            return _PIPE_INIT[key]
        return init_params

    def cut(*args, **kw):
        wl = make(*args, **kw)
        return dataclasses.replace(
            wl, cfg=dataclasses.replace(wl.cfg, num_layers=PIPE_LAYERS),
            init_params=cached_init(wl.init_params))

    train_torch.get_workload = cut
    try:
        yield
    finally:
        train_torch.get_workload = make


def _pipe_step(torch, cuda, train_torch, argv, timed=False):
    """A run through ``train_torch.build`` at PIPE_LAYERS layers: its
    first step's loss, gradients (this rank's, by name, on the CPU),
    launches, seconds and peak memory (the allocator's high mark over the
    step, parameters and AdamW's moments included, beside what was
    allocated as it began; for a pipelined model also the peak of the
    loss's pass above its start); with ``timed`` a second step's
    milliseconds."""
    gc.collect()  # the last run's state is a reference cycle
    torch.cuda.empty_cache()
    with _pipe_preset(train_torch):
        wl, state, step, batches = train_torch.build(
            train_torch.parse_args(argv))
    grads = {}
    apply = state.apply_gradients

    def record(g):
        if not grads:
            grads.update({k: v.detach().float().cpu() for k, v in g.items()})
        return apply(g)

    state.apply_gradients = record
    model = state.model
    passes = []
    if hasattr(model, "_train"):
        # the pipelined loss's pass (the schedule and the gradients'
        # assembly), its peak above its start: the activation memory that
        # JAX's test compares (the whole step's peak on rank 0 is the
        # optimizer update's, the same under every schedule)
        run = model._train

        def measured(ids, *args):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
            out = run(ids, *args)
            torch.cuda.synchronize()
            passes.append(torch.cuda.max_memory_allocated() - start)
            return out

        model._train = measured
    batch = next(batches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    cuda.launches.clear()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(cuda.launches)
    peak = torch.cuda.max_memory_allocated()
    if passes:
        model._train = run
    step_ms = None
    if timed:
        batch = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
    out = {"seconds": seconds, "step_ms": step_ms,
           "metrics": {k: float(v) for k, v in m.items()}, "grads": grads,
           "launches": launches, "peak_mem_gib": peak / 2**30,
           "start_mem_gib": before / 2**30,
           "pass_mem_gib": passes[0] / 2**30 if passes else None,
           "saved_high": getattr(model, "last_stats", {}).get("saved_high"),
           "bubble": model.bubble_fraction()
           if hasattr(model, "bubble_fraction") else None}
    del state, step, batches, model, record, apply, passes
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _rel(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def _pipe_compare(got, ref):
    """Loss (relative) and gradient (of each one's max-abs) errors of a
    rank's run against the dense run: the rank's parameters only."""
    loss, rloss = got["metrics"]["loss"], ref["metrics"]["loss"]
    errs = {k: _rel(g, ref["grads"][k]) for k, g in got["grads"].items()}
    return {"loss": loss, "ref_loss": rloss,
            "loss_rel_err": abs(loss - rloss) / abs(rloss),
            "grad_err": max(errs.values()),
            "worst_grad": max(errs, key=errs.get)}


def _pipe_kinds():
    """Every worker run: (schedule, virtual, dtype, wire)."""
    return [(s, v, dt, "fp32") for dt in ("float32", "bfloat16")
            for s, v in PIPE_RUNS] + \
        [(s, v, "bfloat16", "bf16") for s, v in PIPE_WIRE_RUNS]


def _pipe_results(torch, out_dir) -> dict:
    """A split worker's rank of the pipeline phase: every run of
    :func:`_pipe_kinds` through ``--mesh data=1,pipe=2`` over gloo, each
    held against the main process's dense reference of its dtype (read
    from ``out_dir`` once it is there): the comparisons, launches, memory
    and times."""
    import train_torch
    from distributedtensorflow_tpu_torch.ops import _cuda

    results, refs = {}, {}
    for kind in _pipe_kinds():
        # each schedule timed once, in bf16 (the preset's dtype) on the
        # fp32 wire
        got = _pipe_step(torch, _cuda, train_torch, _pipe_argv(*kind),
                         timed=kind[2:] == ("bfloat16", "fp32"))
        dtype = kind[2]
        if dtype not in refs:
            deadline = time.time() + 600
            while not os.path.exists(f"{out_dir}/refs.done"):
                if time.time() > deadline:
                    raise TimeoutError("pipeline: no references")
                time.sleep(0.5)
            refs[dtype] = torch.load(f"{out_dir}/ref_{dtype}.pt")
        row = {k: got[k] for k in ("launches", "seconds", "step_ms",
                                   "metrics", "peak_mem_gib",
                                   "start_mem_gib", "pass_mem_gib",
                                   "saved_high", "bubble")}
        row["ref"] = _pipe_compare(got, refs[dtype])
        schedule, v, _, wire = kind
        if wire == "bf16" or schedule != "gpipe":
            # the bf16 wire against the fp32 wire (bit for bit), another
            # schedule against GPipe's of the same chunk count
            base = results[(schedule if wire == "bf16" else "gpipe", v,
                            dtype, "fp32")]["_grads"]
            row["vs_base_grad_err"] = max(_rel(got["grads"][k], g)
                                          for k, g in base.items())
            row["bitwise_equal_base"] = all(
                torch.equal(got["grads"][k], g) for k, g in base.items())
        row["_grads"] = got["grads"]
        results[kind] = row
    for row in results.values():
        row.pop("_grads")
    return results


def _pipe_launches(schedule):
    """K2 and K3f launches a step on each rank: PIPE_LAYERS / 2 layers a
    rank x PIPE_MICRO microbatches, K3f once and K2 once a forward: GPipe
    (and the circular order) runs the forward and the remat recompute,
    1F1B and interleaved the forward unit, the backward unit's forward
    from the saved input and its remat recompute."""
    units = PIPE_LAYERS // 2 * PIPE_MICRO
    forwards = 2 if schedule == "gpipe" else 3
    return {"flash_fwd": forwards * units, "flash_bwd_fused": units,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def _pipe_report(ranks) -> tuple:
    """The rows of the workers' results: ``(launches, failures)``; a run
    that a rank did not report is a failure."""
    launches = collections.Counter()
    want_keys = set(_pipe_kinds())
    failures = [("missing", r, sorted(map(str, want_keys - set(rk))))
                for r, rk in enumerate(ranks) if want_keys - set(rk)]
    if failures:
        return launches, failures
    for kind in _pipe_kinds():
        schedule, v, dtype, wire = kind
        loss_tol, grad_tol = PIPE_TOL[dtype]
        got = [rk[kind] for rk in ranks]
        want = _pipe_launches(schedule)
        flash = [{k: g["launches"].get(k, 0) for k in want} for g in got]
        ok = flash == [want, want]
        if wire == "bf16":
            ok = ok and all(g["bitwise_equal_base"] for g in got) \
                and len({g["metrics"]["loss"] for g in got}
                        | {rk[(schedule, v, dtype, "fp32")]["metrics"]
                           ["loss"] for rk in ranks}) == 1
        else:
            ok = ok and all(g["ref"]["loss_rel_err"] <= loss_tol
                            and g["ref"]["grad_err"] <= grad_tol
                            for g in got)
            if schedule != "gpipe" and dtype == "float32":
                ok = ok and all(g["vs_base_grad_err"] <= grad_tol
                                for g in got)
        for g in got:
            launches.update(g["launches"])
        emit({"phase": "pipeline", "schedule": schedule, "pp_virtual": v,
              "dtype": dtype, "handoff": wire, "workload": "gpt_lm",
              "mesh": "data=1,pipe=2", "world": 2, "backend": "gloo",
              "layers": PIPE_LAYERS, "batch": PIPE_BATCH,
              "microbatches": PIPE_MICRO, "bubble": got[0]["bubble"],
              "loss": [g["metrics"]["loss"] for g in got],
              "ref_loss": got[0]["ref"]["ref_loss"],
              "loss_rel_err": [g["ref"]["loss_rel_err"] for g in got],
              "grad_err": [g["ref"]["grad_err"] for g in got],
              "worst_grad": [g["ref"]["worst_grad"] for g in got],
              "base": (f"{schedule}, fp32 wire" if wire == "bf16" else
                       "gpipe" if schedule != "gpipe" else None),
              "vs_base_grad_err": [g.get("vs_base_grad_err") for g in got],
              "bitwise_equal_base": [g.get("bitwise_equal_base")
                                     for g in got],
              "flash_launches": flash, "expected_flash_launches": want,
              "launches_per_rank": [g["launches"] for g in got],
              "saved_high": [g["saved_high"] for g in got],
              "peak_mem_gib": [g["peak_mem_gib"] for g in got],
              "start_mem_gib": [g["start_mem_gib"] for g in got],
              "pass_mem_gib": [g["pass_mem_gib"] for g in got],
              "first_step_s": [g["seconds"] for g in got],
              "step_ms": [g["step_ms"] for g in got],
              "step_ms_label": "gloo on one card, no scaling time",
              "note": PIPE_NOTE, "ok": ok,
              "tolerance": ("bit for bit against the fp32 wire"
                            if wire == "bf16" else
                            f"loss {loss_tol} relative, gradients {grad_tol}"
                            " of each one's max-abs, against one process's"
                            " dense GPTLM on the same batch"
                            + (" and, in fp32, against GPipe's"
                               if schedule != "gpipe" else ""))
              + "; K2 and K3f launches as derived"})
        if not ok:
            failures.append(kind)
    def mem(schedule, key):
        return [rk[(schedule, 1, "float32", "fp32")][key] for rk in ranks]

    gp, fb = mem("gpipe", "pass_mem_gib"), mem("1f1b", "pass_mem_gib")
    ok = all(b < a for a, b in zip(gp, fb))
    emit({"phase": "pipeline_memory", "dtype": "float32",
          "gpipe_pass_gib": gp, "1f1b_pass_gib": fb,
          "gpipe_step_peak_gib": mem("gpipe", "peak_mem_gib"),
          "1f1b_step_peak_gib": mem("1f1b", "peak_mem_gib"),
          "start_gib": mem("gpipe", "start_mem_gib"),
          "saved_high": {s: mem(s, "saved_high") for s in ("gpipe", "1f1b")},
          "ok": ok, "claim": "1F1B's pass below GPipe's on each rank (the "
                             "loss's pass, its peak above its start: the "
                             "activations; the step's peak on rank 0 is "
                             "the update's)"})
    if not ok:
        failures.append("memory")
    return launches, failures


def _pipe_write_refs(torch, cuda, train_torch, out_dir):
    """The dense one-process references (fp32 and bf16) into ``out_dir``,
    then the ``refs.done`` marker the workers wait for."""
    for dtype in ("float32", "bfloat16"):
        ref = _pipe_step(torch, cuda, train_torch,
                         _pipe_argv(None, 1, dtype, mesh=False))
        torch.save(ref, f"{out_dir}/ref_{dtype}.pt")
        del ref
    _PIPE_INIT.clear()
    with open(f"{out_dir}/refs.done", "w") as f:
        f.write("ok\n")


def run_pipeline(torch, cuda, train_torch, train_row, workers):
    """gpt_lm at full width cut to PIPE_LAYERS layers over ``--mesh
    data=1,pipe=2``: the split ``workers`` over gloo on the one card run
    GPipe, circular GPipe, 1F1B and interleaved in fp32 and bf16 and the
    bf16 wire, each against one process's dense model from the same seed
    (:func:`_pipe_write_refs`, first: the workers' runs wait for it),
    each rank's K2/K3f launches against the derived counts, 1F1B's peak
    memory below GPipe's.  Then ``--mesh data=1,pipe=1`` over NCCL
    against the train phase's losses bit for bit (at pipe=1 the step
    takes the plain path: this checks only that the pipe group
    builds)."""
    from distributedtensorflow_tpu_torch.parallel import bootstrap

    t0 = time.time()
    _pipe_write_refs(torch, cuda, train_torch, SPLIT_DIRS["pipeline"])
    emit({"phase": "pipeline_refs_seconds", "seconds": time.time() - t0})
    state, _, _, launches, row = train_steps(
        torch, cuda, train_torch, _train_args(
            train_torch, "--mesh", "data=1,pipe=1", "--dist-backend",
            "nccl"), 2, "pipeline_pipe1_nccl")
    del state
    bootstrap.shutdown()
    torch.cuda.empty_cache()
    _check_launches("pipeline_pipe1_nccl", launches, 2,
                    TRAIN_LAUNCHES_PER_STEP)
    if train_row is not None:
        row["train_losses"] = train_row["losses"][:3]
        row["equal_to_train"] = row["losses"] == row["train_losses"]
    emit(row)
    if train_row is not None and not row["equal_to_train"]:
        raise AssertionError("pipeline_pipe1_nccl: losses differ from "
                             "the train phase's")
    ranks = _split_results(torch, workers, "pipeline")
    worker_launches, failures = _pipe_report(ranks)
    launches = collections.Counter(launches)
    launches.update(worker_launches)
    emit({"phase": "pipeline_seconds", "seconds": time.time() - t0})
    if failures:
        raise AssertionError(f"pipeline: {failures} failed")
    return launches


#: The splitckpt phase (checkpoints, clipping and LAMB over the split
#: axes): gpt_lm at full width (gpt_moe for expert) cut to
#: SPLITCK_LAYERS layers, batch SPLITCK_BATCH at seq SPLITCK_SEQ (the
#: flash gate's length), dropout 0, LAMB with ``--clipnorm 1.0``.
SPLITCK_LAYERS, SPLITCK_BATCH, SPLITCK_SEQ = 2, 2, 1024
#: (name, preset, mesh, pipeline schedule), in the workers' order; each
#: in SPLITCK_DTYPES.  Over pipe both sides take the chunked head.
SPLITCK_LAYOUTS = (("model2", "gpt_lm", "data=1,model=2", None),
                   ("pipe2", "gpt_lm", "data=1,pipe=2", "1f1b"),
                   ("expert2", "gpt_moe", "data=1,expert=2", None))
SPLITCK_DTYPES = ("float32", "bfloat16")
#: The fp32 runs whose step-2 checkpoints the main process restores into
#: one process and steps once more (each also hands over its split step
#: 3's parameters; model2 its first step's gradients and parameters).
SPLITCK_HELD = ("model2", "pipe2")
SPLITCK_CKPTS = "build/splitckpt_ckpts"
#: The kernels each run's resumed steps must launch on every rank.
SPLITCK_KERNELS = {
    "model2": ("layernorm_fwd", "layernorm_bwd", "flash_fwd",
               "flash_bwd_fused", *HEAD_KERNELS),
    "pipe2": ("layernorm_fwd", "layernorm_bwd", "flash_fwd",
              "flash_bwd_fused"),
    "expert2": ("layernorm_fwd", "layernorm_bwd", "flash_fwd",
                "flash_bwd_fused", *HEAD_KERNELS)}
#: Against one process (SCALE_TOL's fp32 pair): the loss 1e-5 relative,
#: the gradients 1e-4 of each one's max-abs, parameters 1e-5 of each
#: one's max-abs (the scaleout phase's measure); after a step from the
#: same restored state also each parameter's update norm within
#: SPLITCK_NORM_TOL (a trust ratio scales the whole update).  The first
#: LAMB step is held on the split run's own gradients: its elementwise
#: update divides each gradient by its magnitude, so gradients that
#: round apart near 0 move a zero-initialised bias by up to 7e-4 of its
#: max-abs (measured on the card).
SPLITCK_TOL = SCALE_TOL["float32"]
SPLITCK_NORM_TOL = 1e-3
SPLITCK_NOTE = ("two processes on one card over gloo (the gathers through "
                "the host), beside the main process's one-process runs: "
                "no time here is a scaling time")
#: The seeded states of a process's builds: (config, seed) -> state.
_SPLITCK_INIT: dict = {}


def _splitck_argv(layout, dtype, mesh=True):
    """train_torch's flags of a splitckpt run of ``layout`` (a
    SPLITCK_LAYOUTS row); ``mesh=False``: the one-process twin."""
    name, preset, axes, schedule = layout
    argv = ["--workload", preset, "--batch-size", str(SPLITCK_BATCH),
            "--seq-len", str(SPLITCK_SEQ), "--accum-steps", "1", "--dtype",
            dtype, "--seed", str(SEED), "--device", "cuda",
            "--prefetch-depth", "0", "--optimizer", "lamb", "--lr", "1e-3",
            "--weight-decay", "0.01", "--clipnorm", "1.0"]
    if schedule:
        argv += ["--pipeline-schedule", schedule, "--xent-impl", "chunked"]
    if mesh:
        argv += ["--mesh", axes, "--dist-backend", "gloo"]
    return argv


def _splitck_build(train_torch, argv, seed=SEED, **fields):
    """``train_torch.build`` at SPLITCK_LAYERS layers, dropout 0 (and the
    config's ``fields``), its weights the dense state of ``seed`` (drawn
    once a process, :data:`_SPLITCK_INIT`; a pipe rank keeps its stage's
    entries)."""
    make = train_torch.get_workload

    def init_params(init):
        def draw(cfg, generator):
            key = (repr(dataclasses.replace(cfg, dtype=None)), seed)
            if key not in _SPLITCK_INIT:
                _SPLITCK_INIT[key] = init(cfg, generator.manual_seed(seed))
            return _SPLITCK_INIT[key]
        return draw

    def cut(*args, **kw):
        wl = make(*args, **kw)
        return dataclasses.replace(
            wl, cfg=dataclasses.replace(wl.cfg, num_layers=SPLITCK_LAYERS,
                                        dropout_rate=0.0, **fields),
            init_params=init_params(wl.init_params))

    train_torch.get_workload = cut
    try:
        return train_torch.build(train_torch.parse_args(argv))
    finally:
        train_torch.get_workload = make


def _hand_over(torch, tree, path, rank) -> None:
    """``tree`` saved by rank 0 for the main process (written aside, then
    renamed: the main process waits for the file)."""
    if rank == 0:
        torch.save(tree, path + ".part")
        os.replace(path + ".part", path)


def _splitck_run(torch, cuda, train_torch, layout, dtype):
    """One splitckpt run on this rank: 4 clipped steps uninterrupted, an
    async save of step 2 among them (its blocking ms: the gather and the
    copy to the host); a fresh build from another seed,
    ``restore_latest`` (its seconds), ``skip_batches`` and steps 3-4
    again.  The losses, the fingerprints, the launches of the resumed
    steps, each part's seconds.  The held runs hand the main process the
    whole parameters of the split step 3, and model2's its first step's
    whole gradients and parameters after."""
    from distributedtensorflow_tpu_torch.checkpoint import CheckpointManager
    from distributedtensorflow_tpu_torch.checkpoint.manager import group_max
    from distributedtensorflow_tpu_torch.data import (
        current_input_context,
        device_put_batch,
        skip_batches,
    )
    from distributedtensorflow_tpu_torch.parallel import collectives

    name = layout[0]
    held = dtype == "float32" and name in SPLITCK_HELD
    argv = _splitck_argv(layout, dtype)
    gc.collect()
    torch.cuda.empty_cache()
    t = {"start": time.perf_counter()}
    wl, state, step, batches = _splitck_build(train_torch, argv)
    mesh, place = state.placement.mesh, state.placement
    rank = collectives.group_rank(mesh.world)
    t["built"] = time.perf_counter()
    ck = f"{SPLITCK_CKPTS}/{name}_{dtype}"
    mgr = CheckpointManager(ck, mesh=mesh.world)
    grads = {}
    if held and name == "model2":
        apply = state.apply_gradients

        def record(g):  # the first step's gradients (this rank's pieces)
            if not grads:
                grads.update({k: v.detach().clone() for k, v in g.items()})
            return apply(g)

        state.apply_gradients = record
    losses = []
    for i in range(4):
        if i == 2:
            saved_fp = _fingerprint(state)
            pieces_fp = _pieces_fp(dict(state.model.named_parameters()))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.save(2, state)  # asynchronous
            save_ms = 1e3 * (time.perf_counter() - t0)
        state, m = step(state, next(batches))
        losses.append(float(m["loss"]))
        if i == 0 and grads:
            whole = {k: place.whole_piece(k, g).cpu()
                     for k, g in grads.items()}
            _hand_over(torch, {"grads": whole,
                               "params": place.gather_params(state.model),
                               "loss": losses[0]},
                       f"{SPLITCK_CKPTS}/first_step.pt", rank)
            del whole
            grads.clear()
    t["steps"] = time.perf_counter()
    mgr.wait()
    commit_s = time.perf_counter() - t["steps"]
    group_max(0, mesh.world)  # the chief's step 2 is committed
    u_fp = _fingerprint(state)
    del state, step, batches
    gc.collect()
    torch.cuda.empty_cache()
    t["u_done"] = time.perf_counter()
    wl, fresh, step, _ = _splitck_build(train_torch, argv, seed=SEED + 1)
    t["rebuilt"] = time.perf_counter()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = mgr.restore_latest(fresh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restored_ok = restored is not None and fresh.step == 2 and \
        _fingerprint(fresh) == saved_fp
    source = skip_batches(wl.input_fn(current_input_context(
        wl.global_batch_size, mesh), SEED), 2)
    cuda.launches.clear()
    r_losses = []
    for i in range(2):
        fresh, m = step(fresh, device_put_batch(next(source),
                                                fresh.model.device, mesh))
        r_losses.append(float(m["loss"]))
        if i == 0 and held:
            _hand_over(torch, place.gather_params(fresh.model),
                       f"{ck}_step3.pt", rank)
    torch.cuda.synchronize()
    launches = dict(cuda.launches)
    r_fp = _fingerprint(fresh)
    t["resumed"] = time.perf_counter()
    nbytes = os.path.getsize(f"{ck}/2/state.pt")
    group_max(0, mesh.world)  # both ranks are done with the checkpoint
    if rank == 0 and not held:
        shutil.rmtree(ck, ignore_errors=True)  # the main process's are kept
    del fresh, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "resumed_losses": r_losses,
            "bit_equal": r_losses == losses[2:] and r_fp == u_fp,
            "restored_equal_saved": restored_ok, "pieces_fp": pieces_fp,
            "save_blocking_ms": save_ms, "commit_wait_s": commit_s,
            "restore_s": restore_s, "checkpoint_bytes": nbytes,
            "seconds": {"build": t["built"] - t["start"],
                        "steps_1_4": t["steps"] - t["built"],
                        "fresh_build": t["rebuilt"] - t["u_done"],
                        "restore_and_steps_3_4": t["resumed"] - t["rebuilt"],
                        "run": t["resumed"] - t["start"]},
            "launches": launches, "coords": dict(mesh.coords)}


def _splitck_results(torch, out_dir) -> dict:
    """A split worker's rank of the splitckpt phase: every run of
    SPLITCK_LAYOUTS x SPLITCK_DTYPES, the held fp32 ones first, so that
    the main process works on them while the rest run."""
    import train_torch
    from distributedtensorflow_tpu_torch.ops import _cuda

    runs = [(layout, dtype) for dtype in SPLITCK_DTYPES
            for layout in SPLITCK_LAYOUTS]
    runs.sort(key=lambda r: not (r[1] == "float32"
                                 and r[0][0] in SPLITCK_HELD))
    results = {}
    for layout, dtype in runs:
        results[layout[0], dtype] = _splitck_run(torch, _cuda, train_torch,
                                                 layout, dtype)
    _SPLITCK_INIT.clear()
    return results


def _splitck_cut(whole: dict, cfg, layout, coords, wl) -> dict:
    """A rank's pieces of a whole parameter state, cut as
    ``create_sharded_state`` cuts the model (model: ``tp_rules``; pipe:
    the stage's entries)."""
    from distributedtensorflow_tpu_torch import models as mods
    from distributedtensorflow_tpu_torch.parallel import sharding

    if layout[0] == "pipe2":
        return mods.convert.pipeline_state(whole, cfg, stage=coords["pipe"],
                                           n_stages=2)
    rules = sharding.tp_rules(mods.GPTLM(cfg, device="meta"), cfg,
                              wl.layout)
    return sharding.shard_state(whole, rules, coords["model"], 2)


def _max_err(got: dict, ref: dict) -> tuple:
    """The largest difference of a tensor over its max-abs, and its
    name."""
    errs = {k: float((got[k].detach().float().cpu() - v.float()).abs().max()
                     / v.float().abs().max().clamp_min(1e-30))
            for k, v in ref.items()}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def _update_norm_err(got: dict, ref: dict, before: dict) -> tuple:
    """The largest relative difference of a parameter's update norm (a
    trust ratio scales a whole parameter's update), and its name."""
    errs = {}
    for k, v in ref.items():
        b = before[k].detach().float().cpu()
        errs[k] = abs(float((got[k].detach().float().cpu() - b).norm()
                            / (v.float() - b).norm().clamp_min(1e-30))
                      - 1.0)
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def _params_of(model) -> dict:
    return {k: p.detach().clone() for k, p in model.named_parameters()}


def _pieces_fp(named: dict) -> str:
    """The fingerprint of a rank's parameters (name -> tensor)."""
    from distributedtensorflow_tpu_torch.utils import tree_fingerprint

    return tree_fingerprint(named)


def _splitck_first_step(torch, train_torch, workers):
    """(c): model2's first LAMB step held against one process's from the
    same seed: the loss and the gradients (SPLITCK_TOL), then the
    one-process LAMB update of the split run's own whole gradients
    against the split update (parameters 1e-5 of their max-abs)."""
    path = f"{SPLITCK_CKPTS}/first_step.pt"
    _wait_files([path], workers, "splitckpt")
    split = torch.load(path, map_location="cpu", weights_only=True)
    gc.collect()
    torch.cuda.empty_cache()
    layout = SPLITCK_LAYOUTS[0]
    wl, state, step, batches = _splitck_build(
        train_torch, _splitck_argv(layout, "float32", mesh=False))
    before = _params_of(state.model)
    grads = {}
    apply = state.apply_gradients

    def record(g):  # before the optimizer clips them in place
        grads.update({k: v.detach().clone().float().cpu()
                      for k, v in g.items()})
        return apply(g)

    state.apply_gradients = record
    state, m = step(state, next(batches))
    loss = float(m["loss"])
    grad_err, worst_grad = _max_err(split["grads"], grads)
    del state, step, batches
    gc.collect()
    wl, state, _, _ = _splitck_build(
        train_torch, _splitck_argv(layout, "float32", mesh=False))
    dev = state.model.device
    state.apply_gradients({k: v.to(dev) for k, v in
                           split["grads"].items()})
    param_err, worst_param = _max_err(_params_of(state.model),
                                      split["params"])
    out = {"loss": loss, "split_loss": split["loss"],
           "loss_rel_err": abs(loss - split["loss"]) / abs(loss),
           "grad_err": grad_err, "worst_grad": worst_grad,
           "param_err_same_grads": param_err, "worst_param": worst_param}
    out["ok"] = (out["loss_rel_err"] <= SPLITCK_TOL[0]
                 and grad_err <= SPLITCK_TOL[1]
                 and param_err <= SPLITCK_TOL[0])
    del state, split, before
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _splitck_one_process(torch, train_torch, layout, workers):
    """(b) and (d) for a held layout: its fp32 step-2 checkpoint restored
    into one process on the card (the seconds), each rank's cut of the
    restored parameters against the rank's own fingerprint, one clipped
    step against the split step 3 (the loss, each parameter and its
    update's norm), then an async save of the one-process state (its
    blocking ms)."""
    from distributedtensorflow_tpu_torch.checkpoint import CheckpointManager

    name = layout[0]
    ck = f"{SPLITCK_CKPTS}/{name}_float32"
    _wait_files([f"{ck}_step3.pt"], workers, "splitckpt")
    gc.collect()
    torch.cuda.empty_cache()
    wl, state, step, batches = _splitck_build(
        train_torch, _splitck_argv(layout, "float32", mesh=False))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = CheckpointManager(ck).restore_latest(state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if restored is None or state.step != 2:
        raise AssertionError(f"splitckpt: {ck} did not restore")
    before = _params_of(state.model)
    pieces = {r: _pieces_fp(_splitck_cut(
        before, wl.cfg, layout, {"model": r, "pipe": r}, wl))
        for r in range(2)}
    for _ in range(2):  # the split run's first two batches
        next(batches)
    state, m = step(state, next(batches))
    split = torch.load(f"{ck}_step3.pt", map_location="cpu",
                       weights_only=True)
    after = _params_of(state.model)
    norm_err, worst = _update_norm_err(after, split, before)
    param_err, worst_param = _max_err(after, split)
    torch.cuda.synchronize()
    mgr = CheckpointManager(f"{SPLITCK_CKPTS}/one_{name}")
    t0 = time.perf_counter()
    mgr.save(int(state.step), state)
    save_ms = 1e3 * (time.perf_counter() - t0)
    mgr.wait()
    out = {"restore_s": restore_s, "save_blocking_ms": save_ms,
           "loss": float(m["loss"]), "pieces_fp": pieces,
           "param_err": param_err, "worst_param": worst_param,
           "update_norm_err": norm_err, "worst_update_norm": worst}
    del state, step, batches, split, before, after
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_splitckpt(torch, cuda, train_torch, workers):
    """Checkpoints, clipping and LAMB over the split axes.  In the split
    ``workers`` over gloo on the one card, each run of SPLITCK_LAYOUTS in
    fp32 and bf16, LAMB with ``--clipnorm 1.0`` (:func:`_splitck_run`):
    (a) the resumed steps' losses and the state's fingerprint equal the
    uninterrupted run's bit for bit, the restored state the saved one's,
    and the resumed steps launch SPLITCK_KERNELS on every rank.  Here, in
    one process: (b) the fp32 model=2 and pipe=2 step-2 checkpoints
    restore, each rank's cut of the restored parameters has that rank's
    fingerprint, and one clipped step equals the split step 3 (the loss
    and each parameter 1e-5, each parameter's update norm 1e-3:
    SPLITCK_TOL, SPLITCK_NORM_TOL); (c) model=2's first LAMB step against one
    process's (:func:`_splitck_first_step`); (d) the split save's blocking
    ms and the restore's seconds beside this process's."""
    t0 = time.time()
    failures = []
    try:
        first = _splitck_first_step(torch, train_torch, workers)
        one = {layout[0]: _splitck_one_process(torch, train_torch, layout,
                                               workers)
               for layout in SPLITCK_LAYOUTS if layout[0] in SPLITCK_HELD}
        ranks = _split_results(torch, workers, "splitckpt")
    finally:
        shutil.rmtree(SPLITCK_CKPTS, ignore_errors=True)
        _SPLITCK_INIT.clear()
    launches = collections.Counter()
    want = {(layout[0], dtype) for layout in SPLITCK_LAYOUTS
            for dtype in SPLITCK_DTYPES}
    missing = [sorted(map(str, want - set(rk))) for rk in ranks
               if want - set(rk)]
    if missing:
        raise AssertionError(f"splitckpt: runs missing {missing}")
    for layout in SPLITCK_LAYOUTS:
        name = layout[0]
        for dtype in SPLITCK_DTYPES:
            got = [rk[name, dtype] for rk in ranks]
            kernels = [{k: g["launches"].get(k, 0)
                        for k in SPLITCK_KERNELS[name]} for g in got]
            ok = all(g["bit_equal"] and g["restored_equal_saved"]
                     and all(kernels[i].values())
                     for i, g in enumerate(got))
            row = {"phase": "splitckpt", "layout": name, "dtype": dtype,
                   "workload": layout[1], "mesh": layout[2],
                   "schedule": layout[3], "layers": SPLITCK_LAYERS,
                   "batch": SPLITCK_BATCH, "seq": SPLITCK_SEQ,
                   "optimizer": "lamb", "clipnorm": 1.0,
                   "losses": [g["losses"] for g in got],
                   "resumed_losses": [g["resumed_losses"] for g in got],
                   "bit_equal": [g["bit_equal"] for g in got],
                   "restored_equal_saved": [g["restored_equal_saved"]
                                            for g in got],
                   "kernels_resumed_steps": kernels,
                   "save_blocking_ms": [g["save_blocking_ms"] for g in got],
                   "commit_wait_s": [g["commit_wait_s"] for g in got],
                   "restore_s": [g["restore_s"] for g in got],
                   "checkpoint_bytes": got[0]["checkpoint_bytes"],
                   "seconds": [g["seconds"] for g in got],
                   "note": SPLITCK_NOTE, "ok": ok}
            if dtype == "float32" and name in one:
                ref = one[name]
                by = {g["coords"]["model" if name == "model2" else "pipe"]:
                      g for g in got}
                same = all(ref["pieces_fp"][r] == by[r]["pieces_fp"]
                           for r in range(2))
                split_loss = got[0]["resumed_losses"][0]
                step_ok = ref["update_norm_err"] <= SPLITCK_NORM_TOL and \
                    ref["param_err"] <= SPLITCK_TOL[0] and \
                    abs(ref["loss"] - split_loss) <= \
                    SPLITCK_TOL[0] * abs(split_loss)
                row.update({
                    "one_process_restore_s": ref["restore_s"],
                    "one_process_save_blocking_ms": ref["save_blocking_ms"],
                    "one_process_pieces_equal": same,
                    "one_process_step3_loss": ref["loss"],
                    "one_process_step3_param_err": ref["param_err"],
                    "worst_param": ref["worst_param"],
                    "one_process_step3_update_norm_err":
                        ref["update_norm_err"],
                    "worst_update_norm": ref["worst_update_norm"],
                    "tolerance": f"restored pieces bit for bit; step 3 "
                                 f"loss {SPLITCK_TOL[0]} relative, each "
                                 f"parameter {SPLITCK_TOL[0]} of its "
                                 f"max-abs, its update's norm "
                                 f"{SPLITCK_NORM_TOL} relative"})
                row["ok"] = ok = ok and same and step_ok
            for g in got:
                launches.update(g["launches"])
            emit(row)
            if not ok:
                failures.append((name, dtype))
    emit({"phase": "splitckpt_lamb", "mesh": "data=1,model=2",
          "dtype": "float32", **first,
          "tolerance": f"loss {SPLITCK_TOL[0]} relative, gradients "
                       f"{SPLITCK_TOL[1]} of each one's max-abs, the "
                       f"update of the same gradients {SPLITCK_TOL[0]} of "
                       f"each parameter's max-abs"})
    if not first["ok"]:
        failures.append("lamb")
    emit({"phase": "splitckpt_seconds", "seconds": time.time() - t0})
    if failures:
        raise AssertionError(f"splitckpt: {failures} failed")
    return launches


#: The splitzero phase (PR 22): ZeRO, the bucketed overlap, the dynamics
#: and quantised stages over the split axes.  gpt_lm at full width (768,
#: 12 heads, vocab 50257) cut to SPLITZ_LAYERS layers (gpt_moe for
#: expert), dropout 0, batch SPLITZ_BATCH at SPLITZ_SEQ tokens (twice that
#: over seq, so that a rank's chunk of 1024 passes the flash gate).
SPLITZ_LAYERS, SPLITZ_BATCH, SPLITZ_SEQ = SPLITCK_LAYERS, 2, 1024
_PIPE_1F1B = ("--pipeline-schedule", "1f1b", "--xent-impl", "chunked")
#: (name, preset, mesh, flags) of the two-rank --dynamics-every 1 runs.
SPLITZ_DYN = (("seq2", "gpt_lm", "data=1,seq=2", ()),
              ("expert2", "gpt_moe", "data=1,expert=2", ()),
              ("pipe2", "gpt_lm", "data=1,pipe=2", _PIPE_1F1B),
              ("zero2", "gpt_lm", "data=2", ("--zero",)))
SPLITZ_DTYPES = ("float32", "bfloat16")
SPLITZ_QUANT = ("int8", "fp8")
#: A rank's dynamics/ values against one process's StepStats of the same
#: gathered whole tensors (fp32 sums of one set of values in another
#: order), both dtypes: relative; non-finite counts exactly.  The
#: quantised pipeline's fp32 loss against the dense quantised model's in
#: one process: relative (the two run the same kernels, fp32).
SPLITZ_STAT_RTOL = 1e-5
SPLITZ_QUANT_RTOL = SCALE_TOL["float32"][0]
#: The four-rank group: (name, preset, mesh, flags), gpt_moe at a
#: capacity factor of its expert count (no token dropped: the one-process
#: reference routes the same tokens), batch QUAD_BATCH; QUAD_STEPS fp32
#: steps under --zero --overlap against one process; QUAD_TIMED bf16
#: steps after one warm-up with and without --zero --overlap.
QUAD_MESHES = (("seq2", "gpt_lm", "data=2,seq=2", ()),
               ("expert2", "gpt_moe", "data=2,expert=2", ()),
               ("pipe2", "gpt_lm", "data=2,pipe=2", _PIPE_1F1B))
QUAD_BATCH, QUAD_STEPS, QUAD_TIMED = 4, 2, 3
QUAD_DIR = "build/quad_check"
QUAD_KERNELS = ("layernorm_fwd", "layernorm_bwd", "flash_fwd",
                "flash_bwd_fused")
#: Against one process (PR 18-21's fp32 measures): the losses 1e-5
#: relative, the first step's gradients 1e-4 of each one's max-abs, each
#: parameter's update norm over the two steps SPLITCK_NORM_TOL (Adam
#: divides each entry by its own root, so a near-zero gradient entry
#: summed in another order moves its update by a sign; the norm of a
#: whole parameter's update does not feel it); a ZeRO rank's optimizer
#: state 0.45-0.55 of the unsharded one's.
QUAD_TOL = SCALE_TOL["float32"]
SPLITZ_NOTE = ("processes on one card over gloo (collectives through the "
               "host): no time here is a scaling time")


def _splitz_argv(preset, axes, dtype, extra=(), batch=SPLITZ_BATCH,
                 mesh=True):
    """train_torch's flags of a splitzero or quad run; ``mesh=False``: the
    one-process twin."""
    seq = SPLITZ_SEQ * (2 if "seq=" in axes else 1)
    argv = ["--workload", preset, "--batch-size", str(batch), "--seq-len",
            str(seq), "--accum-steps", "1", "--dtype", dtype, "--seed",
            str(SEED), "--device", "cuda", "--prefetch-depth", "0", *extra]
    if mesh:
        argv += ["--mesh", axes, "--dist-backend", "gloo"]
    return argv


def _fields(preset):
    """The config fields a run of ``preset`` replaces (gpt_moe: the
    capacity factor of its 8 experts, no token dropped)."""
    return {"capacity_factor": 8.0} if preset == "gpt_moe" else {}


def _splitz_build(train_torch, argv, preset):
    """:func:`_splitck_build` of ``argv``, and the mesh ``build`` made."""
    real, made = train_torch.bootstrap_mesh, []

    def keep(args):
        made.append(real(args))
        return made[-1]

    train_torch.bootstrap_mesh = keep
    try:
        wl, state, step, batches = _splitck_build(train_torch, argv,
                                                  **_fields(preset))
    finally:
        train_torch.bootstrap_mesh = real
    return wl, state, step, batches, made[0][0]


def _whole(torch, state, tensors, rows=False):
    """The whole tensors (dense names) of this rank's ``tensors``: ZeRO's
    ``rows`` gathered over the batch group and unchunked first, then the
    pieces of a split model put together (``Placement.gather``); on the
    CPU, fp32.  Collective: every rank calls it."""
    from distributedtensorflow_tpu_torch.parallel import collectives
    from distributedtensorflow_tpu_torch.parallel import zero as zero_lib

    if rows:
        z = state.zero
        tensors = {n: zero_lib.unchunk_array(collectives.all_gather(
            tensors[n].contiguous(), z.group).reshape(z.degree, -1), p.shape)
            for n, p in zip(z.names, z.params)}
    if state.placement is not None:
        tensors = state.placement.gather(tensors)
    return {k: v.detach().float().cpu().clone() for k, v in tensors.items()}


class _Named:
    """A model-like holder of named tensors (``named_parameters``)."""

    def __init__(self, tensors):
        self.tensors = tensors

    def named_parameters(self):
        return iter(self.tensors.items())


def _splitz_dyn_run(torch, cuda, train_torch, layout, dtype):
    """One --dynamics-every 1 step on this rank: its ``dynamics/`` values,
    and those of one process's StepStats (no split) on the step's whole
    gradients and parameters (gathered on every rank, computed on the
    card), the launches and the seconds."""
    from distributedtensorflow_tpu_torch.obs import dynamics as dynlib

    name, preset, axes, extra = layout
    t0 = time.perf_counter()
    wl, state, step, batches, mesh = _splitz_build(
        train_torch, _splitz_argv(preset, axes, dtype,
                                  ("--dynamics-every", "1", *extra)), preset)
    seen = {}
    before, after = dynlib.StepStats.before, dynlib.StepStats.after

    def spy_before(self, model, grads):
        seen["grads"] = {k: v.detach().clone() for k, v in grads.items()}
        seen["old"] = {k: p.detach().clone()
                       for k, p in model.named_parameters()}
        return before(self, model, grads)

    def spy_after(self, model, stats, old):
        seen["new"] = {k: p.detach().clone()
                       for k, p in model.named_parameters()}
        return after(self, model, stats, old)

    batch = next(batches)
    torch.cuda.synchronize()
    cuda.launches.clear()
    dynlib.StepStats.before, dynlib.StepStats.after = spy_before, spy_after
    try:
        state, m = step(state, batch)
    finally:
        dynlib.StepStats.before, dynlib.StepStats.after = before, after
    torch.cuda.synchronize()
    launches = dict(cuda.launches)
    got = {k: float(v) for k, v in m.items()
           if k.startswith(dynlib.METRIC_PREFIX)}
    rows = state.zero is not None
    whole = {"grads": _whole(torch, state, seen["grads"], rows),
             "old": _whole(torch, state, seen["old"]),
             "new": _whole(torch, state, seen["new"])}
    modules = train_torch.dynamics_modules(wl.cfg, state.model)
    dev = state.model.device
    on = {k: {n: t.to(dev) for n, t in v.items()} for k, v in whole.items()}
    ref = dynlib.StepStats(list(on["old"]), modules)
    stats, old = ref.before(_Named(on["old"]), on["grads"])
    stats = ref.after(_Named(on["new"]), stats, old)
    ref = {k: float(v) for k, v in stats.items()}
    errs = {k: abs(got[k] - v) / max(abs(v), 1e-30) for k, v in ref.items()
            if "/nonfinite/" not in k}
    counts_equal = all(got[k] == v for k, v in ref.items()
                       if "/nonfinite/" in k)
    del state, step, batches, seen, whole, on, old, stats
    gc.collect()
    torch.cuda.empty_cache()
    return {"dynamics": got, "keys_equal": set(got) == set(ref),
            "stat_rel_err": max(errs.values()),
            "worst_stat": max(errs, key=errs.get),
            "counts_equal": counts_equal, "launches": launches,
            "loss": float(m["loss"]), "coords": dict(mesh.coords),
            "seconds": time.perf_counter() - t0}


def _splitz_quant_run(torch, cuda, train_torch, mode):
    """One fp32 step of gpt_lm at ``--quant mode`` over pipe=2 (1F1B):
    its loss and launches."""
    _, state, step, batches, _ = _splitz_build(
        train_torch, _splitz_argv("gpt_lm", "data=1,pipe=2", "float32",
                                  ("--quant", mode, *_PIPE_1F1B)), "gpt_lm")
    cuda.launches.clear()
    state, m = step(state, next(batches))
    torch.cuda.synchronize()
    out = {"loss": float(m["loss"]), "launches": dict(cuda.launches),
           "quant_layers": sum(type(mod).__name__ == "QuantDense"
                               for mod in state.model.modules())}
    del state, step, batches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _splitz_results(torch, out_dir) -> dict:
    """A split worker's rank of the splitzero phase: every SPLITZ_DYN
    layout in SPLITZ_DTYPES, then the quantised pipeline's runs."""
    import train_torch
    from distributedtensorflow_tpu_torch.ops import _cuda

    results = {}
    for dtype in SPLITZ_DTYPES:
        for layout in SPLITZ_DYN:
            results[layout[0], dtype] = _splitz_dyn_run(
                torch, _cuda, train_torch, layout, dtype)
    for mode in SPLITZ_QUANT:
        results["quant", mode] = _splitz_quant_run(torch, _cuda, train_torch,
                                                   mode)
    _SPLITCK_INIT.clear()
    return results


def run_splitzero(torch, cuda, train_torch, workers):
    """The two-rank checks of PR 22, in the split ``workers`` over gloo on
    the one card: (a) ``--dynamics-every 1`` over seq=2, expert=2, pipe=2
    (1F1B) and data=2 with ``--zero``, fp32 and bf16: both ranks'
    ``dynamics/`` values bit-equal, and equal to one process's StepStats
    of the same gathered whole gradients and parameters within
    SPLITZ_STAT_RTOL; (b) ``--quant int8`` and ``fp8`` over pipe=2: the
    fp32 loss within SPLITZ_QUANT_RTOL of the dense quantised model's in
    this process (same weights, same batch), which runs while the workers
    do."""
    t0 = time.time()
    dense = {}
    for mode in SPLITZ_QUANT:
        _, state, step, batches, _ = _splitz_build(
            train_torch, _splitz_argv("gpt_lm", "data=1,pipe=2", "float32",
                                      ("--quant", mode, "--xent-impl",
                                       "chunked"), mesh=False), "gpt_lm")
        state, m = step(state, next(batches))
        dense[mode] = float(m["loss"])
        del state, step, batches
        gc.collect()
        torch.cuda.empty_cache()
    ranks = _split_results(torch, workers, "splitzero")
    _SPLITCK_INIT.clear()
    launches, failures = collections.Counter(), []
    for dtype in SPLITZ_DTYPES:
        for name, preset, axes, extra in SPLITZ_DYN:
            got = [rk[name, dtype] for rk in ranks]
            same = got[0]["dynamics"] == got[1]["dynamics"]
            ok = same and all(
                g["keys_equal"] and g["counts_equal"]
                and g["stat_rel_err"] <= SPLITZ_STAT_RTOL for g in got)
            for g in got:
                launches.update(g["launches"])
            emit({"phase": "splitzero_dynamics", "layout": name,
                  "dtype": dtype, "workload": preset, "mesh": axes,
                  "flags": list(extra), "layers": SPLITZ_LAYERS,
                  "batch": SPLITZ_BATCH, "modules": sorted(
                      {k.split("/")[-1] for k in got[0]["dynamics"]}),
                  "global_grad_norm":
                      got[0]["dynamics"]["dynamics/global_grad_norm"],
                  "ranks_bit_equal": same,
                  "stat_rel_err": [g["stat_rel_err"] for g in got],
                  "worst_stat": got[0]["worst_stat"],
                  "losses": [g["loss"] for g in got],
                  "launches": [g["launches"] for g in got],
                  "seconds": [g["seconds"] for g in got], "ok": ok,
                  "tolerance": f"ranks bit for bit; one process's stats of "
                               f"the gathered tensors {SPLITZ_STAT_RTOL} "
                               "relative, counts exactly",
                  "note": SPLITZ_NOTE})
            if not ok:
                failures.append((name, dtype))
    for mode in SPLITZ_QUANT:
        got = [rk["quant", mode] for rk in ranks]
        errs = [abs(g["loss"] - dense[mode]) / abs(dense[mode]) for g in got]
        ok = max(errs) <= SPLITZ_QUANT_RTOL and all(
            g["quant_layers"] > 0 for g in got)
        for g in got:
            launches.update(g["launches"])
        emit({"phase": "splitzero_quant_pipe", "quant": mode,
              "mesh": "data=1,pipe=2", "schedule": "1f1b", "dtype": "float32",
              "losses": [g["loss"] for g in got], "dense_loss": dense[mode],
              "loss_rel_err": errs,
              "quant_layers": [g["quant_layers"] for g in got],
              "launches": [g["launches"] for g in got], "ok": ok,
              "tolerance": f"loss {SPLITZ_QUANT_RTOL} relative to the dense "
                           "quantised model's in one process"})
        if not ok:
            failures.append(("quant", mode))
    emit({"phase": "splitzero_seconds", "seconds": time.time() - t0})
    if failures:
        raise AssertionError(f"splitzero: {failures} failed")
    return launches


def _quad_run(torch, cuda, train_torch, layout, dtype, flags, steps):
    """``steps`` steps of a quad run on this rank: the losses, each
    step's seconds, the launches; in fp32 under ZeRO also the first
    step's whole gradients, the whole parameters after, and the
    optimizer state's bytes beside the unsharded state's."""
    name, preset, axes, extra = layout
    wl, state, step, batches, mesh = _splitz_build(
        train_torch, _splitz_argv(preset, axes, dtype, (*flags, *extra),
                                  batch=QUAD_BATCH), preset)
    keep = dtype == "float32" and state.zero is not None
    first = {}
    if keep:
        apply = state.zero.apply_gradients

        def record(st, grads, **kw):  # this rank's summed rows
            if not first:
                first.update({k: v.detach().clone() for k, v in grads.items()})
            return apply(st, grads, **kw)

        state.zero.apply_gradients = record
    cuda.launches.clear()
    losses, secs = [], []
    for _ in range(steps):
        batch = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    out = {"losses": losses, "step_s": secs, "launches": dict(cuda.launches),
           "coords": dict(mesh.coords)}
    if keep:
        out["grads"] = _whole(torch, state, first, rows=True)
        out["params"] = _whole(torch, state, dict(
            state.model.named_parameters()))
        out["opt_state_bytes"] = sum(
            v.numel() * v.element_size()
            for st in state.optimizer.state.values()
            for v in st.values() if torch.is_tensor(v) and v.dim())
        # AdamW's two fp32 moments of this rank's own (unsharded) pieces
        out["unsharded_bytes"] = 2 * 4 * sum(
            p.numel() for p in state.model.parameters())
        out["overlap"] = state.overlap.describe()
    del state, step, batches, first
    gc.collect()
    torch.cuda.empty_cache()
    return out


def quad_worker(out_dir) -> int:
    """One rank of the four-rank group (``--quad-worker``): the cluster
    from torchrun's variables, gloo, every QUAD_MESHES mesh in fp32 under
    ``--zero --overlap`` (QUAD_STEPS steps) and in bf16 with and without
    them (one warm-up and QUAD_TIMED steps); saved as
    ``<out_dir>/rank<r>.pt`` (aside, then renamed)."""
    import torch

    import train_torch
    from distributedtensorflow_tpu_torch.ops import _cuda
    from distributedtensorflow_tpu_torch.parallel import bootstrap

    both = ("--zero", "--overlap")
    results = {}
    for layout in QUAD_MESHES:
        name = layout[0]
        results[name, "float32"] = _quad_run(torch, _cuda, train_torch,
                                             layout, "float32", both,
                                             QUAD_STEPS)
        for tag, flags in (("zero_overlap", both), ("plain", ())):
            results[name, tag] = _quad_run(torch, _cuda, train_torch, layout,
                                           "bfloat16", flags, 1 + QUAD_TIMED)
    _SPLITCK_INIT.clear()
    path = f"{out_dir}/rank{bootstrap.process_index()}.pt"
    torch.save(results, path + ".part")
    os.replace(path + ".part", path)
    bootstrap.shutdown()
    return 0


def _start_quad_workers():
    """The four-rank group on the one card (``LOCAL_RANK`` 0), its
    directory emptied first."""
    from distributedtensorflow_tpu_torch.parallel import bootstrap

    shutil.rmtree(QUAD_DIR, ignore_errors=True)
    os.makedirs(QUAD_DIR)
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(bootstrap.free_port()), "WORLD_SIZE": "4",
           "LOCAL_RANK": "0"}
    return [subprocess.Popen([sys.executable, __file__, "--quad-worker",
                              QUAD_DIR], env={**env, "RANK": str(r)})
            for r in range(4)]


def _quad_reference(torch, cuda, train_torch, layout):
    """One process's QUAD_STEPS fp32 steps of a quad mesh's model on its
    global batch (the two replicas' pipelines, rank-major), from the same
    weights; gpt_moe routes its tokens in the four ranks' shards
    (:func:`_shard_routed`): the losses, the first step's gradients and
    the parameters after."""
    import functools

    from distributedtensorflow_tpu_torch.data import (
        InputContext,
        device_put_batch,
    )
    from distributedtensorflow_tpu_torch.models.gpt_moe import (
        MoEMLP,
        _expert_mlp,
    )
    from distributedtensorflow_tpu_torch.parallel.moe import local_moe

    name, preset, axes, extra = layout
    wl, state, step, _, _ = _splitz_build(
        train_torch, _splitz_argv(preset, axes, "float32",
                                  ("--xent-impl", "chunked")
                                  if name == "pipe2" else (),
                                  batch=QUAD_BATCH, mesh=False), preset)
    if preset == "gpt_moe":
        for mod in state.model.modules():
            if isinstance(mod, MoEMLP):
                mod.moe_fn = functools.partial(_shard_routed, local_moe,
                                               _expert_mlp, mod.cfg, 4)
    grads = {}
    apply = state.apply_gradients

    def record(g):
        if not grads:
            grads.update({k: v.detach().float().cpu() for k, v in g.items()})
        return apply(g)

    state.apply_gradients = record
    init = {k: p.detach().float().cpu().clone()
            for k, p in state.model.named_parameters()}
    srcs = [wl.input_fn(InputContext(2, r, QUAD_BATCH), SEED)
            for r in range(2)]
    losses = []
    for _ in range(QUAD_STEPS):
        parts = [next(src) for src in srcs]
        state, m = step(state, device_put_batch(
            {k: np.concatenate([q[k] for q in parts]) for k in parts[0]},
            state.model.device))
        losses.append(float(m["loss"]))
    out = {"losses": losses, "grads": grads, "init": init,
           "params": {k: p.detach().float().cpu()
                      for k, p in state.model.named_parameters()}}
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_quad(torch, cuda, train_torch, workers):
    """The four-rank group (``quad_worker``, four gloo processes on the
    one card, started with the split workers): each QUAD_MESHES mesh
    under ``--zero --overlap`` in fp32 against one process's steps from
    the same weights and global batch (:func:`_quad_reference`, here
    while the ranks run): the losses, the first step's gradients, each
    parameter's update norm over the steps (QUAD_TOL, SPLITCK_NORM_TOL);
    each rank's optimizer state about half of the unsharded one's; the
    launches of QUAD_KERNELS on every rank (and the fused head's over
    expert); the bf16 step ms with and without ``--zero --overlap``."""
    t0 = time.time()
    refs = {layout[0]: _quad_reference(torch, cuda, train_torch, layout)
            for layout in QUAD_MESHES}
    _SPLITCK_INIT.clear()
    paths = [f"{QUAD_DIR}/rank{r}.pt" for r in range(4)]
    _wait_files(paths, workers, "quad")
    ranks = [torch.load(p) for p in paths]
    rcs = [p.wait(timeout=120) for p in workers]
    shutil.rmtree(QUAD_DIR, ignore_errors=True)
    if any(rcs):
        raise AssertionError(f"quad: the ranks exited with {rcs}")
    launches, failures = collections.Counter(), []
    for name, preset, axes, extra in QUAD_MESHES:
        ref = refs[name]
        got = [rk[name, "float32"] for rk in ranks]
        loss_err = max(abs(a - b) / abs(b) for g in got
                       for a, b in zip(g["losses"], ref["losses"]))
        grad_err = max(_grad_errs(g["grads"], ref["grads"]) for g in got)
        norm_err = max(_update_norm_err(g["params"], ref["params"],
                                        ref["init"])[0] for g in got)
        ratios = [g["opt_state_bytes"] / g["unsharded_bytes"] for g in got]
        kernels = QUAD_KERNELS + (HEAD_KERNELS if preset == "gpt_moe"
                                  else ())
        counts = [{k: g["launches"].get(k, 0) for k in kernels} for g in got]
        ok = (loss_err <= QUAD_TOL[0] and grad_err <= QUAD_TOL[1]
              and norm_err <= SPLITCK_NORM_TOL
              and all(0.45 <= r <= 0.55 for r in ratios)
              and all(all(c.values()) for c in counts))
        for g in got:
            launches.update(g["launches"])
        timed = {}
        for tag in ("zero_overlap", "plain"):
            runs = [rk[name, tag] for rk in ranks]
            for g in runs:
                launches.update(g["launches"])
            timed[tag] = statistics.median(
                1e3 * s for g in runs for s in g["step_s"][1:])
        emit({"phase": "quad_zero_overlap", "mesh": axes, "workload": preset,
              "flags": ["--zero", "--overlap", *extra], "world": 4,
              "layers": SPLITZ_LAYERS, "batch": QUAD_BATCH,
              "losses": got[0]["losses"], "ref_losses": ref["losses"],
              "loss_rel_err": loss_err, "grad_err": grad_err,
              "update_norm_err": norm_err, "opt_state_ratio": ratios,
              "opt_state_bytes": [g["opt_state_bytes"] for g in got],
              "overlap": got[0]["overlap"], "kernel_launches": counts,
              "bf16_step_ms_median": timed, "ok": ok,
              "tolerance": f"losses {QUAD_TOL[0]} relative, first-step "
                           f"gradients {QUAD_TOL[1]} of each one's max-abs, "
                           f"each parameter's update norm {SPLITCK_NORM_TOL} "
                           "relative, against one process; optimizer state "
                           "0.45-0.55 of the unsharded",
              "note": SPLITZ_NOTE})
        if not ok:
            failures.append(name)
    emit({"phase": "quad_seconds", "seconds": time.time() - t0})
    if failures:
        raise AssertionError(f"quad: {failures} failed")
    return launches


DS_STEPS = 12            # gpt_lm steps of each (a)/(b) run
DS_RESNET = (256, 6)     # imagenet_resnet50's batch and steps in (c)
DS_KERNELS = ("layernorm_fwd", "layernorm_bwd", "flash_fwd",
              "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv",
              *HEAD_KERNELS)
#: the worker of split 0 serves the preset's stream of seed + 1009
DS_SPLIT0_SEED = 1009


@contextlib.contextmanager
def _shifted_input(train_torch, shift):
    """``train_torch``'s presets reading their stream of ``seed + shift``
    (a data worker's split, fed in-process), inside the block."""
    make = train_torch.get_workload

    def shifted(*args, **kw):
        wl = make(*args, **kw)
        fn = wl.input_fn
        return dataclasses.replace(
            wl, input_fn=lambda ctx, seed: fn(ctx, seed + shift))

    train_torch.get_workload = shifted
    try:
        yield
    finally:
        train_torch.get_workload = make


def _ds_run(torch, cuda, train_torch, argv, logdir, device):
    """``train_torch.main(argv)`` logging every step into ``logdir``:
    its losses, its metrics rows, the launches counted from 0 over it,
    its seconds."""
    from distributedtensorflow_tpu_torch import obs

    # the registry is the process's: earlier runs' workers stay in it
    before = set(obs.default_registry().scalars())
    cuda.launches.clear()
    t0 = time.time()
    records = train_torch.main([*argv, "--log-every", "1", "--logdir",
                                logdir])
    sync(torch, torch.device(device))
    rows = [{k: v for k, v in r.items() if k not in before
             or not k.startswith("data_service_fetch_seconds")}
            for r in _rows_of(os.path.join(logdir, "metrics.jsonl"))
            if "t_step" in r]
    out = {"losses": [r["loss"] for r in records], "rows": rows,
           "launches": dict(cuda.launches), "seconds": time.time() - t0}
    empty_cache(torch, torch.device(device))
    return out


def _ds_steady(rows, batch):
    """Median step ms of the steps after the first, their examples/s and
    mean data-wait share."""
    steady = rows[1:] or rows
    t_step = statistics.median(r["t_step"] for r in steady)
    return {"step_ms_median": 1e3 * t_step,
            "examples_per_sec": batch / t_step,
            "f_data_mean": statistics.fmean(r.get("f_data", 0.0)
                                            for r in steady)}


def _ds_record_problems(tag, rows, steps, workers,
                        every=True) -> list[str]:
    """Every record of a service run (``every``; else its last) has both
    adaptive depths >= 1 and one fetch histogram a worker of the run."""
    out = []
    if len(rows) != steps:
        out.append(f"{tag}: {len(rows)} records, expected {steps}")
    for r in rows if every else rows[-1:]:
        fetch = [k for k in r if k.startswith(
            "data_service_fetch_seconds_count.worker_")]
        if not (r.get("data_prefetch_depth", 0) >= 1
                and r.get("data_client_window", 0) >= 1
                and len(fetch) == workers):
            out.append(f"{tag}: step {r.get('step')}: depth "
                       f"{r.get('data_prefetch_depth')}, window "
                       f"{r.get('data_client_window')}, fetch fields "
                       f"{fetch}")
    return out


def run_dataservice(torch, cuda, train_torch, device="cuda"):
    """Phase 23 (see the module's docstring): the data service and the
    adaptive depths feeding gpt_lm and ResNet-50 on the card.  On the CPU
    (a rehearsal) the test sizes run, ``DS_RESNET`` cut small, and the
    launch checks are left out."""
    import tempfile

    cuda_dev = device == "cuda"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ds_")
    t0 = time.time()
    failures, launches = [], collections.Counter()
    try:
        argv = [*_trainer_argv(device), "--steps", str(DS_STEPS),
                "--adaptive-prefetch"]
        runs = {}
        for tag, extra in (("service2", ("--data-service", "2")),
                           ("service1", ("--data-service", "1"))):
            runs[tag] = _ds_run(torch, cuda, train_torch, [*argv, *extra],
                                os.path.join(tmp, tag), device)
        with _shifted_input(train_torch, DS_SPLIT0_SEED):
            runs["direct"] = _ds_run(torch, cuda, train_torch, argv,
                                     os.path.join(tmp, "direct"), device)
        for tag, workers in (("service2", 2), ("service1", 1)):
            failures += _ds_record_problems(tag, runs[tag]["rows"],
                                            DS_STEPS, workers)
        for run in runs.values():
            launches.update(run["launches"])
            if not all(math.isfinite(x) for x in run["losses"]):
                failures.append(f"losses not finite: {run['losses']}")
        if cuda_dev:
            for tag, run in runs.items():
                want = {k: DS_STEPS * TRAIN_LAUNCHES_PER_STEP[k]
                        for k in DS_KERNELS}
                got = {k: run["launches"].get(k, 0) for k in DS_KERNELS}
                if got != want:
                    failures.append(f"{tag}: launches {got}, expected "
                                    f"{want}")
        bit_equal = runs["service1"]["losses"] == runs["direct"]["losses"]
        if not bit_equal:
            failures.append("--data-service 1's losses differ from the "
                            "in-process feed of its worker's stream")
        cfg = train_torch.get_workload("gpt_lm",
                                       test_size=not cuda_dev).cfg
        gpt = {"phase": "dataservice", "part": "gpt_lm", "steps": DS_STEPS,
               "batch": 8, "seq": 2048 if cuda_dev else None,
               "layers": cfg.num_layers, "hidden": cfg.hidden_size,
               "bit_equal_one_split": bit_equal}
        for tag, run in runs.items():
            gpt[tag] = {**_ds_steady(run["rows"], 8),
                        "seconds": run["seconds"],
                        "losses": run["losses"],
                        "launches": run["launches"],
                        "prefetch_depth": [r.get("data_prefetch_depth")
                                           for r in run["rows"]],
                        "client_window": [r.get("data_client_window")
                                          for r in run["rows"]]}
        emit(gpt)
        batch, steps = DS_RESNET
        base = ["--workload", "imagenet_resnet50", "--batch-size",
                str(batch), "--seed", str(SEED), "--device", device,
                "--steps", str(steps), "--adaptive-prefetch",
                *([] if cuda_dev else ["--test-size"])]
        resnet = {}
        for tag, extra in (("service2", ("--data-service", "2")),
                           ("synthetic", ())):
            run = _ds_run(torch, cuda, train_torch, [*base, *extra],
                          os.path.join(tmp, f"resnet_{tag}"), device)
            launches.update(run["launches"])
            resnet[tag] = {**_ds_steady(run["rows"], batch),
                           "seconds": run["seconds"],
                           "losses": run["losses"],
                           "prefetch_depth": [r.get("data_prefetch_depth")
                                              for r in run["rows"]],
                           "client_window": [r.get("data_client_window")
                                             for r in run["rows"]]}
            if not all(math.isfinite(x) for x in run["losses"]):
                failures.append(f"resnet {tag}: losses {run['losses']}")
            if extra:
                # a 154 MB batch takes a worker a while: both have
                # delivered by the last step
                failures += _ds_record_problems(f"resnet {tag}", run["rows"],
                                                steps, 2, every=False)
        emit({"phase": "dataservice", "part": "imagenet_resnet50",
              "batch": batch, "steps": steps,
              "batch_mb": batch * 224 * 224 * 3 * 4 / 1e6,
              "budget_mb": 256.0, **resnet,
              "earlier_images_per_sec": {"synthetic_pr9": 3563.0,
                                         "records_pr16": 1321.3}})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "dataservice_seconds", "seconds": time.time() - t0})
    if failures:
        raise AssertionError(f"dataservice: {failures}")
    return launches


JOBS_LAYERS = 2          # (a): gpt_lm at full width cut to 2 layers
JOBS_STEPS = 4           # (a): the trainer's steps, a checkpoint every 2
JOBS_EVERY = 2
JOBS_EVAL_RTOL = 1e-6    # (a): the sidecar's eval_loss against this process
JOBS_PS_STEPS = 6        # (b): async steps a worker (batch 256 a worker)
JOBS_KILL_STEPS = 12     # (b): the kill run's steps a worker
JOBS_KILL_AT = 8         # (b): the global version the kill waits for
JOBS_CLUSTER_STEPS = 2   # (c): steps of the TF_CONFIG cluster's workers
JOBS_CLOSURES = 6        # (d): slow closures over two process workers


def _jobs_eval_launches(layers):
    """Launches of one eval forward of gpt_lm at ``layers`` layers: the
    LayerNorm forward twice a block and once for ln_f, the flash forward
    once a block, the fused head's forward once."""
    return {**NO_LAUNCHES, "layernorm_fwd": 2 * layers + 1,
            "flash_fwd": layers, "fused_xent_fwd": 1}


def _gpt_step_launches(layers):
    """Launches of one gpt_lm (or gpt_moe) training step at ``layers``
    layers (block remat, K3f, the fused head): the LayerNorm forward
    twice a LayerNorm and once for ln_f, backward once each, the flash
    forward twice a layer, K3f once, the head once each."""
    return {**NO_LAUNCHES, "layernorm_fwd": 4 * layers + 1,
            "layernorm_bwd": 2 * layers + 1, "flash_fwd": 2 * layers,
            "flash_bwd_fused": layers, "fused_xent_fwd": 1,
            "fused_xent_dx": 1, "fused_xent_dw": 1}


def _jobs_pid(x):
    """(d)'s closure: the worker's pid and twice ``x``."""
    return os.getpid(), 2 * x


def _jobs_slow(x):
    """(d)'s closure that a kill interrupts: the worker's pid and ``x``."""
    time.sleep(0.4)
    return os.getpid(), x


def _jobs_sidecar(torch, cuda, train_torch, tmp, device):
    """(a): the trainer (``train_torch.main``, this thread) and the
    ``--job evaluator`` sidecar (another thread) on one checkpoint
    directory, then the evaluated step restored here and evaluated on the
    same batches.  Returns the row and the failures."""
    import threading

    from distributedtensorflow_tpu_torch.checkpoint import CheckpointManager
    from distributedtensorflow_tpu_torch.data import (
        current_input_context,
        device_put_batch,
    )
    from distributedtensorflow_tpu_torch.train import (
        TrainState,
        make_eval_step,
        weighted_evaluate,
    )
    from distributedtensorflow_tpu_torch.train import sidecar as sidecar_mod

    cuda_dev = device == "cuda"
    ck = os.path.join(tmp, "ck")
    workload = _trainer_argv(device)
    evals, out = [], {}
    timed = sidecar_mod.SidecarEvaluator._evaluate_state

    def evaluate_state(self, step, state):
        t0 = time.perf_counter()
        metrics = timed(self, step, state)  # float() of each: synced
        evals.append({"step": step, "ms": 1e3 * (time.perf_counter() - t0)})
        return metrics

    def evaluator():
        try:
            out["history"] = train_torch.main(
                ["--job", "evaluator", *workload, "--checkpoint-dir", ck,
                 "--steps", str(JOBS_STEPS), "--poll-interval", "0.2",
                 "--idle-timeout", "60"])
        except BaseException as e:  # noqa: BLE001 — reported below
            out["error"] = repr(e)

    failures = []
    sidecar_mod.SidecarEvaluator._evaluate_state = evaluate_state
    try:
        with _cut_config(train_torch, num_layers=JOBS_LAYERS):
            cuda.launches.clear()
            t0 = time.time()
            thread = threading.Thread(target=evaluator, name="jobs-sidecar")
            thread.start()
            try:
                records = train_torch.main(
                    [*workload, "--steps", str(JOBS_STEPS), "--log-every",
                     str(JOBS_EVERY), "--checkpoint-dir", ck,
                     "--checkpoint-every", str(JOBS_EVERY)])
            finally:
                thread.join(timeout=600)
            sync(torch, torch.device(device))
            launches = dict(cuda.launches)
            seconds = time.time() - t0
            # the evaluated step restored here, on the evaluator's batches
            args = train_torch.parse_args(workload)
            wl = train_torch.workload_of(args)
            model = wl.model_cls(wl.cfg, device=device)
            state = TrainState.create(model, wl.make_optimizer)
            CheckpointManager(ck).restore(JOBS_STEPS, state)
            ctx = current_input_context(wl.global_batch_size)
            batches = [device_put_batch(b, device) for b, _ in zip(
                wl.input_fn(ctx, SEED + 999), range(train_torch.EVAL_STEPS))]
            eval_step = make_eval_step(wl.eval_fn(model))
            sync(torch, torch.device(device))
            t1 = time.perf_counter()
            ref = weighted_evaluate(eval_step, state, iter(batches))
            ref_ms = 1e3 * (time.perf_counter() - t1)
            del model, state, batches
    finally:
        sidecar_mod.SidecarEvaluator._evaluate_state = timed
    empty_cache(torch, torch.device(device))
    history = out.get("history") or {}
    if "error" in out or JOBS_STEPS not in history:
        failures.append(f"(a) the evaluator: {out.get('error')}, evaluated "
                        f"{sorted(history)}")
        got = None
    else:
        got = history[JOBS_STEPS]["loss"]
        if abs(got - ref["loss"]) > JOBS_EVAL_RTOL * abs(ref["loss"]):
            failures.append(f"(a) eval_loss {got} against {ref['loss']} "
                            "in this process")
    n_evals = len(history)
    step_l = _gpt_step_launches(JOBS_LAYERS)
    eval_l = _jobs_eval_launches(JOBS_LAYERS)
    want = {k: JOBS_STEPS * step_l[k]
            + n_evals * train_torch.EVAL_STEPS * eval_l[k]
            for k in (*DS_KERNELS,)}
    got_l = {k: launches.get(k, 0) for k in want}
    if cuda_dev and got_l != want:
        failures.append(f"(a) launches {got_l}, expected {want}")
    losses = [r["loss"] for r in records]
    if not all(math.isfinite(x) for x in losses):
        failures.append(f"(a) trainer losses {losses}")
    row = {"phase": "jobs", "part": "sidecar", "layers": JOBS_LAYERS,
           "batch": 8, "seq": 2048 if cuda_dev else None,
           "steps": JOBS_STEPS, "checkpoint_every": JOBS_EVERY,
           "trainer_losses": losses, "evaluated_steps": sorted(history),
           "evaluations": evals, "eval_loss": got,
           "eval_loss_here": ref["loss"],
           "eval_loss_rel_err": None if got is None
           else abs(got - ref["loss"]) / abs(ref["loss"]),
           "bit_equal": got == ref["loss"], "rtol": JOBS_EVAL_RTOL,
           "eval_ms_here": ref_ms, "launches": got_l,
           "expected_launches": want, "seconds": seconds}
    return row, failures


def _jobs_async_ps(torch, train_torch, tmp, device, out):
    """(b): ``train_torch.main --job async-ps`` on widedeep at its
    preset width, 2 PS shards and 2 worker processes computing on
    ``device``; the trainer it made is kept (its final parameters and
    where its workers ran).  Then the first batch worker 0 trained on,
    under the seeded initial weights and under the final ones."""
    from distributedtensorflow_tpu_torch.data import (
        InputContext,
        device_put_batch,
    )
    from distributedtensorflow_tpu_torch.parallel import param_server as pps

    base = pps.AsyncPSTrainer
    made = []

    class Kept(base):
        def stop(self):
            self.kept = {"version": self.global_version(),
                         "params": self.current_params(),
                         "where": self.worker_devices()}
            made.append(self)
            super().stop()

    test = [] if device == "cuda" else ["--test-size"]
    t0 = time.time()
    pps.AsyncPSTrainer = Kept
    try:
        records = train_torch.main(
            ["--job", "async-ps", "--workload", "widedeep", "--num-ps", "2",
             "--num-workers", "2", "--steps", str(JOBS_PS_STEPS), "--seed",
             str(SEED), "--device", device, "--logdir",
             os.path.join(tmp, "async_ps"), *test])
    finally:
        pps.AsyncPSTrainer = base
    seconds = time.time() - t0
    kept = made[0].kept
    wl = train_torch.get_workload("widedeep", test_size=bool(test),
                                  global_batch_size=2 * 256)
    model = wl.model_cls(wl.cfg, device=device)
    loss_fn = wl.loss_fn(model)
    first = device_put_batch(next(wl.input_fn(InputContext(2, 0, 512), SEED)),
                             device)
    first_loss = {}
    for tag, params in (("initial", wl.init_params(
            wl.cfg, torch.Generator().manual_seed(SEED))), ("final", {
                k: torch.from_numpy(v) for k, v in kept["params"].items()})):
        model.load_state_dict(params)
        with torch.no_grad():
            first_loss[tag] = float(loss_fn(first)[0])
    out["b"] = {"records": records, "version": kept["version"],
                "where": kept["where"], "first_batch_loss": first_loss,
                "seconds": seconds}


def _jobs_kill(trainer_cls, device, out):
    """(b)'s fault: an ``AsyncPSTrainer`` (widedeep, 2 PS, 2 workers of
    JOBS_KILL_STEPS steps, 50 ms between steps) whose worker 1 is killed
    once the global version reaches JOBS_KILL_AT; worker 0 finishes."""
    from distributedtensorflow_tpu_torch.parallel.sharding import (
        MinSizePartitioner,
    )

    t0 = time.time()
    trainer = trainer_cls(
        "widedeep", num_ps=2, num_workers=2, steps=JOBS_KILL_STEPS,
        batch_size=256, test_size=device != "cuda", seed=SEED,
        worker_sleep_s=0.05, device=device,
        partitioner=MinSizePartitioner(min_shard_bytes=64 << 10))
    with trainer:
        trainer.start()
        deadline = time.monotonic() + 300
        while trainer.global_version() < JOBS_KILL_AT:
            if time.monotonic() > deadline:
                raise TimeoutError("(b) the kill run never started")
            time.sleep(0.05)
        before = trainer.global_version()
        trainer.kill_worker(1)
        trainer.join(timeout=300)
        results = trainer.worker_results()
        out["kill"] = {"version_at_kill": before,
                       "version_after": trainer.global_version(),
                       "finished": sorted(results),
                       "survivor_steps": len(results.get(0, ([],))[0]),
                       "where": trainer.worker_devices(),
                       "seconds": time.time() - t0}


def _jobs_coordinator(out):
    """(d): a Coordinator of two process workers with status servers:
    each answers ``/varz``; JOBS_CLOSURES slow closures run out of
    process while worker 0 is killed mid-closure (its closure re-queues,
    it respawns once); then a closure on each worker."""
    import urllib.request

    from distributedtensorflow_tpu_torch.parallel import coordinator as pc

    t0 = time.time()
    respawns = lambda: sum(pc._M_RESPAWNS.value(worker=str(i))  # noqa: E731
                           for i in range(2))
    r0, q0 = respawns(), pc._M_RETRIED.value()
    coord = pc.Coordinator(num_workers=2, use_processes=True,
                           worker_status_ports=True, respawn_backoff_s=0.05,
                           respawn_backoff_max_s=0.1)
    try:
        start_s = time.time() - t0
        varz = {}
        for addr in coord.worker_status_addrs():
            with urllib.request.urlopen(f"http://{addr}/varz",
                                        timeout=30) as r:
                varz[addr] = r.status
        pids = coord.worker_pids()
        rvs = [coord.schedule(_jobs_slow, (i,)) for i in range(JOBS_CLOSURES)]
        time.sleep(0.15)  # worker 0 is inside its first closure
        coord.kill_worker_process(0)
        coord.join(timeout=120)
        got = [rv.fetch() for rv in rvs]
        after = [coord.schedule(_jobs_pid, (i,)) for i in range(4)]
        coord.join(timeout=120)
        later = [rv.fetch() for rv in after]
        out["d"] = {"varz_status": list(varz.values()),
                    "results": sorted(v for _, v in got),
                    "closure_pids": sorted({p for p, _ in got + later}),
                    "pids_before": pids, "pids_after": coord.worker_pids(),
                    "parent_pid": os.getpid(),
                    "requeued": pc._M_RETRIED.value() - q0,
                    "respawns": respawns() - r0,
                    "later": sorted(v for _, v in later),
                    "start_s": start_s, "seconds": time.time() - t0}
    finally:
        coord.shutdown()


def _jobs_cluster_start(tmp, device):
    """(c): 1 ps, 1 chief and 1 worker of one TF_CONFIG cluster on
    loopback ports, each ``train_torch.py`` (widedeep at its preset
    width), started together."""
    from distributedtensorflow_tpu_torch.parallel.bootstrap import free_port

    cluster = {kind: [f"127.0.0.1:{free_port()}"]
               for kind in ("ps", "chief", "worker")}
    flags = ["--workload", "widedeep", "--steps", str(JOBS_CLUSTER_STEPS),
             "--batch-size", "256", "--idle-timeout", "120", "--seed",
             str(SEED), "--device", device,
             *([] if device == "cuda" else ["--test-size"])]
    here = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for kind in ("ps", "chief", "worker"):
        env = {**os.environ, "DTFT_PS_WAIT_S": "120", "TF_CONFIG": json.dumps(
            {"cluster": cluster, "task": {"type": kind, "index": 0}})}
        log = open(os.path.join(tmp, f"cluster_{kind}.log"), "w")
        procs.append((kind, subprocess.Popen(
            [sys.executable, os.path.join(here, "train_torch.py"), *flags],
            cwd=here, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def run_jobs(torch, cuda, train_torch, device="cuda"):
    """The ``--job`` roles (see the module's docstring): (c)'s three
    processes, (b)'s two async runs and (d)'s process pool start first,
    side by side; (a) runs on the card meanwhile.  On the CPU (a
    rehearsal) the test sizes run and the launch and CUDA checks are
    left out."""
    import tempfile
    import threading

    from distributedtensorflow_tpu_torch.parallel import param_server as pps

    cuda_dev = device == "cuda"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_jobs_")
    t0 = time.time()
    failures, out, errors = [], {}, {}
    threads, cluster = [], []

    def guarded(name, fn, *a):
        def body():
            try:
                fn(*a)
            except BaseException as e:  # noqa: BLE001 — reported below
                errors[name] = repr(e)
        t = threading.Thread(target=body, name=f"jobs-{name}")
        t.start()
        threads.append(t)

    try:
        cluster = _jobs_cluster_start(tmp, device)
        # the class itself, before (b) swaps the module's for one that
        # keeps its end
        guarded("kill", _jobs_kill, pps.AsyncPSTrainer, device, out)
        guarded("b", _jobs_async_ps, torch, train_torch, tmp, device, out)
        guarded("d", _jobs_coordinator, out)
        row_a, fail_a = _jobs_sidecar(torch, cuda, train_torch, tmp, device)
        emit(row_a)
        failures += fail_a
        for t in threads:
            t.join(timeout=600)
        failures += [f"({k}) raised {v}" for k, v in errors.items()]
        # (b)
        total = 2 * 2 * JOBS_PS_STEPS
        if "b" in out:
            b = out["b"]
            final = b["records"][-1]
            hist = final.get("staleness_hist", {})
            where = b["where"]
            ok_b = (b["version"] == total and sum(hist.values()) == total
                    and bool(hist) and final.get("final")
                    and b["first_batch_loss"]["final"]
                    < b["first_batch_loss"]["initial"]
                    and sorted(where) == [0, 1]
                    and (not cuda_dev or all(w["cuda_context"]
                                             for w in where.values())))
            emit({"phase": "jobs", "part": "async_ps", "workload": "widedeep",
                  "num_ps": 2, "num_workers": 2, "steps": JOBS_PS_STEPS,
                  "batch_per_worker": 256, "global_version": b["version"],
                  "expected_version": total, "staleness_hist": hist,
                  "loss_first": final.get("loss_first"),
                  "loss_last": final.get("loss_last"),
                  "eval": {k: final[k] for k in ("accuracy", "log_loss")
                           if k in final},
                  "first_batch_loss": b["first_batch_loss"],
                  "workers": where, "seconds": b["seconds"],
                  "updates_per_sec": total / b["seconds"], "ok": ok_b})
            if not ok_b:
                failures.append(f"(b) async-ps: version {b['version']} of "
                                f"{total}, hist {hist}, first batch "
                                f"{b['first_batch_loss']}, workers {where}")
        if "kill" in out:
            k = out["kill"]
            ok_k = (k["finished"] == [0]
                    and k["version_after"] > k["version_at_kill"]
                    and k["survivor_steps"] == JOBS_KILL_STEPS
                    and (not cuda_dev or k["where"][0]["cuda_context"]))
            emit({"phase": "jobs", "part": "async_ps_kill", **k, "ok": ok_k})
            if not ok_k:
                failures.append(f"(b) kill: {k}")
        # (c)
        logs = {}
        for kind, proc, log in cluster:
            rc = proc.wait(timeout=300)
            log.close()
            logs[kind] = (rc, _read(os.path.join(tmp,
                                                  f"cluster_{kind}.log")))
        budget = 2 * JOBS_CLUSTER_STEPS
        ok_c = (all(rc == 0 for rc, _ in logs.values())
                and f"ps task 0 done at version {budget}" in logs["ps"][1]
                and "chief task 0 = async worker 0/2" in logs["chief"][1]
                and "worker task 0 = async worker 1/2" in logs["worker"][1]
                and all("staleness" in logs[k][1]
                        for k in ("chief", "worker")))
        emit({"phase": "jobs", "part": "ps_cluster", "tasks": sorted(logs),
              "rc": {k: rc for k, (rc, _) in logs.items()},
              "steps": JOBS_CLUSTER_STEPS, "push_budget": budget,
              "ok": ok_c, "seconds": time.time() - t0})
        if not ok_c:
            failures.append("(c) ps cluster: " + "; ".join(
                f"{k} rc {rc}: {text[-1500:]}"
                for k, (rc, text) in logs.items()))
        # (d)
        if "d" in out:
            d = out["d"]
            ok_d = (d["varz_status"] == [200, 200]
                    and d["results"] == list(range(JOBS_CLOSURES))
                    and d["parent_pid"] not in d["closure_pids"]
                    and d["requeued"] >= 1 and d["respawns"] == 1
                    and d["later"] == [0, 2, 4, 6]
                    and len(d["pids_after"]) == 2)
            emit({"phase": "jobs", "part": "coordinator", **d, "ok": ok_d})
            if not ok_d:
                failures.append(f"(d) coordinator: {d}")
    finally:
        for t in threads:
            t.join(timeout=60)
        for _, proc, log in cluster:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "jobs_seconds", "seconds": time.time() - t0})
    if failures:
        raise AssertionError(f"jobs: {failures}")
    return collections.Counter(row_a["launches"])


HOSTDIST_STEPS = 4        # (a): optimizer steps of the full-width MPMD run
HOSTDIST_LR = 1e-3        # (a): each stage's Adam
HOSTDIST_KILL_STEPS = 30  # (b): steps of the kill run at the JAX test's size
HOSTDIST_RING_MIB = 64    # (d): the timed fp32 all-reduce of the ring
HOSTDIST_RING_REPS = 3
HOSTDIST_TIMEOUT_S = 5    # (d): the runner's join timeout a sleeper outlives
HOSTDIST_RTOL = 1e-6      # (d): sums and means, of the terms' own reduction


def _mpmd_config(pm, device, **kw):
    """(a)'s MPMD run: GPT-2-small's widths (vocab 50257, hidden 768, 12
    heads, seq 1024) cut to 4 layers over 2 stages, microbatch 4, 4
    microbatches, window 2, fp32; on the CPU (a rehearsal) the JAX test's
    size."""
    full = dict(vocab_size=50257, hidden_size=768, num_heads=12,
                seq_len=1024, microbatch_size=4) if device == "cuda" else {}
    return pm.MPMDConfig(**{
        "n_stages": 2, "n_steps": HOSTDIST_STEPS, "n_microbatches": 4,
        "num_layers": 4, "window": 2, "lr": HOSTDIST_LR, "seed": SEED,
        "device": device, **full, **kw})


def _mpmd_launches(cfg, stage):
    """A stage's launches over the run: each block's two LayerNorms and
    its attention, once in the forward a microbatch sends (not on the
    last stage, whose forward runs under autograd) and once more in the
    recomputation its backward takes, then once backward (K1b, K3f); the
    last stage's ln_f once each way."""
    lps = cfg.num_layers // cfg.n_stages
    last = stage == cfg.n_stages - 1
    passes = 1 if last else 2
    per = {"layernorm_fwd": passes * 2 * lps + last, "flash_fwd": passes * lps,
           "layernorm_bwd": 2 * lps + last, "flash_bwd_fused": lps}
    n = cfg.n_steps * cfg.n_microbatches
    return {**NO_LAUNCHES, **{k: n * v for k, v in per.items()}}


def hostdist_child(task_id, peers, whole, device):
    """(d) in a child of the port's ``testing.run``: the process group is
    up (gloo); ``MultiWorkerMirroredStrategy``'s ``reduce`` and ``gather``
    of this rank's rows of ``whole`` (on ``device``) against numpy's of
    the whole, then a two-rank ``HostCollectives`` ring at ``peers``:
    all-reduce, all-gather, broadcast, barrier and a timed
    HOSTDIST_RING_MIB MiB fp32 all-reduce (the host's loopback)."""
    import numpy as np
    import torch

    from distributedtensorflow_tpu_torch.native import HostCollectives
    from distributedtensorflow_tpu_torch.parallel.mesh import replica_index
    from distributedtensorflow_tpu_torch.strategies import (
        MultiWorkerMirroredStrategy,
    )

    strat = MultiWorkerMirroredStrategy(backend="gloo", device=device)
    n, i = strat.num_replicas_in_sync, replica_index(strat.mesh)
    rows = whole.shape[0] // n
    shard = torch.from_numpy(whole[i * rows:(i + 1) * rows].copy()).to(
        strat.device)
    bad = []
    for op in ("sum", "mean", "max", "min"):
        for axis in (None, 0, 1):
            got = strat.reduce(op, shard, axis=axis)
            want = getattr(np, op)(whole, axis=axis)
            if op in ("sum", "mean"):
                scale = getattr(np, op)(np.abs(whole), axis=axis)
                ok = bool(np.all(np.abs(got - want)
                                 <= HOSTDIST_RTOL * scale))
            else:
                ok = bool(np.array_equal(got, want))
            if not ok or got.shape != np.shape(want):
                bad.append((op, axis))
    gathered = bool(np.array_equal(strat.gather(shard), whole))
    big = np.full(HOSTDIST_RING_MIB << 18, task_id + 1.0, np.float32)
    with HostCollectives(task_id, peers, timeout_ms=120_000) as ring:
        x = np.arange(5, dtype=np.int64) + 10 * task_id
        ring_ok = (np.array_equal(ring.all_reduce(x), 2 * np.arange(5) + 10)
                   and np.array_equal(ring.all_gather(x),
                                      np.stack([x - 10 * task_id,
                                                x - 10 * task_id + 10]))
                   and np.array_equal(ring.broadcast(x, root=1),
                                      np.arange(5) + 10))
        ring.barrier()
        ms = []
        for _ in range(HOSTDIST_RING_REPS):
            ring.barrier()
            t0 = time.perf_counter()
            out = ring.all_reduce(big)
            ms.append(1e3 * (time.perf_counter() - t0))
        ring_ok = ring_ok and bool(np.all(out == 3.0))
    return {"world": strat.mesh.size, "device": str(shard.device),
            "reduce_bad": bad, "gather_equal": gathered, "ring_ok": ring_ok,
            "allreduce_ms": ms, "pid": os.getpid()}


def _hostdist_sleep(task_id, seconds):
    """(d)'s sleeper: task 0 returns at once, the others sleep."""
    if task_id:
        time.sleep(seconds)
    return task_id


def _hostdist_terminate():
    """(d): a child killed by ``terminate`` is an expected exit."""
    from distributedtensorflow_tpu_torch import testing

    runner = testing.MultiProcessRunner(_hostdist_sleep, 2, args=(120,),
                                        init_distributed=False).start()
    runner.terminate(1)
    killed = runner.join(timeout=120)
    return {"values": killed.return_values, "exit_codes": killed.exit_codes}


def _hostdist_timeout():
    """(d): a child asleep past a HOSTDIST_TIMEOUT_S join raises
    ``SubprocessTimeoutError``."""
    from distributedtensorflow_tpu_torch import testing

    t0 = time.time()
    try:
        testing.MultiProcessRunner(
            _hostdist_sleep, 2, args=(60,), init_distributed=False,
            timeout=HOSTDIST_TIMEOUT_S).start().join()
    except testing.SubprocessTimeoutError as e:
        return {"raised_after_s": time.time() - t0,
                "values": e.result.return_values,
                "exit_codes": e.result.exit_codes}
    return None


def _hostdist_children(device):
    """(d): two children of ``testing.run(..., backend="gloo")`` run
    :func:`hostdist_child` on one array and a ring at fresh ports."""
    from distributedtensorflow_tpu_torch import testing

    t0 = time.time()
    whole = np.random.default_rng(SEED).standard_normal((16, 3)).astype(
        np.float32)
    peers = [f"127.0.0.1:{testing.pick_unused_port()}" for _ in range(2)]
    res = testing.run(hostdist_child, 2, args=(peers, whole, device),
                      backend="gloo", timeout=300)
    return {"children": res.return_values, "exit_codes": res.exit_codes,
            "seconds": time.time() - t0}


def _hostdist_kill(pm, device, tmp, coord):
    """(b): the JAX test's kill run (2 stages, 4 microbatches of 4, the
    JAX defaults' widths) on ``device``, HOSTDIST_KILL_STEPS steps, on
    (a)'s warm pool ``coord``: worker 1's process is killed once stage 0
    shows progress (two rows in its trace); every stage closure
    re-queues, the process respawns, the run completes."""
    import threading

    from distributedtensorflow_tpu_torch.parallel import coordinator as pc

    logdir = os.path.join(tmp, "mpmd_kill")
    cfg = pm.MPMDConfig(n_stages=2, n_steps=HOSTDIST_KILL_STEPS,
                        n_microbatches=4, microbatch_size=4,
                        recv_timeout_s=60, connect_timeout_s=45,
                        seed=SEED, device=device)
    respawns = lambda: sum(pc._M_RESPAWNS.value(worker=str(i))  # noqa: E731
                           for i in range(2))
    r0, q0 = respawns(), pc._M_RETRIED.value()
    killed = {}

    def killer():
        path = os.path.join(logdir, "stage0", "trace.jsonl")
        deadline = time.time() + 120
        while time.time() < deadline:
            try:
                with open(path) as f:
                    if sum(1 for _ in f) >= 2:
                        break
            except OSError:
                pass
            time.sleep(0.02)
        coord.kill_worker_process(1)
        killed["t"] = time.time()

    t0 = time.time()
    thread = threading.Thread(target=killer)
    thread.start()
    try:
        res = pm.run_mpmd_pipeline(cfg, logdir, coordinator=coord,
                                   join_timeout_s=400)
    finally:
        thread.join()
    with open(os.path.join(logdir, "stage1", "metrics.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f]
    return {"losses": res["losses"], "stage1_steps": steps,
            "killed": bool(killed), "requeued": pc._M_RETRIED.value() - q0,
            "respawns": respawns() - r0,
            "kill_after_s": killed.get("t", t0) - t0,
            "seconds": time.time() - t0}


def _hostdist_tools(logdir, n_steps, m):
    """(c): ``tools/timeline.py --fleet``, ``check_metrics_schema.py`` and
    ``run_report.py --json`` over (a)'s stage directories, unchanged."""
    stages = [os.path.join(logdir, f"stage{i}") for i in range(2)]
    tl = os.path.join(logdir, "timeline_fleet.json")
    r = subprocess.run([sys.executable, "tools/timeline.py", "--fleet",
                        *stages, "-o", tl], capture_output=True, text=True,
                       timeout=120)
    names = set()
    if r.returncode == 0:
        with open(tl) as f:
            doc = json.load(f)
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        names = {e.get("name") for e in events if e.get("ph") == "X"}
    schema_rc, schema_out = _schema([os.path.join(s, name) for s in stages
                                     for name in ("metrics.jsonl",
                                                  "metrics.prom")])
    reports = []
    for s in stages:
        rep = subprocess.run([sys.executable, "tools/run_report.py", s,
                              "--json"], capture_output=True, text=True,
                             timeout=120)
        reports.append(json.loads(rep.stdout)["pipeline"]
                       if rep.returncode == 0 else None)
    hand = (reports[1] or {}).get("handoff", {})
    ok = (r.returncode == 0 and {"mpmd.step", "pipeline.handoff"} <= names
          and schema_rc == 0 and reports[1] is not None
          and reports[1].get("schedule") == "mpmd"
          and reports[1].get("stages") == 2
          and hand.get("count") == n_steps * m
          and reports[0] is not None and "link_stalls" in reports[0])
    return {"phase": "hostdist", "part": "tools",
            "timeline_rc": r.returncode, "span_names": sorted(
                n for n in names if n), "schema_rc": schema_rc,
            "schema": schema_out[-400:], "pipeline_stage0": reports[0],
            "pipeline_stage1": reports[1],
            "handoff_p50_ms": 1e3 * hand["p50_s"] if "p50_s" in hand
            else None,
            "handoff_p99_ms": 1e3 * hand["p99_s"] if "p99_s" in hand
            else None, "ok": bool(ok)}


def _hostdist_warm():
    """A pool worker's first closure: its CUDA context, cuBLAS handle and
    a first optimizer (``torch.optim`` imports ``torch._dynamo`` at the
    first one: 9.4 s in a fresh process on the H100's host), so that a
    stage's first steps cost no start."""
    import torch

    from distributedtensorflow_tpu_torch.train.optimizers import adamw

    x = torch.nn.Parameter(torch.ones(64, 64, device="cuda"))
    adamw([x], 1e-3, weight_decay=0.0)
    return float((x @ x).sum())


def hostdist_pool(warm=False):
    """The phase's two ``spawn`` process workers (started before the jobs
    phase, so that their Python, torch and, with ``warm``, CUDA starts run
    beside it; jobs waits on process starts of its own)."""
    from distributedtensorflow_tpu_torch.parallel.coordinator import (
        Coordinator,
    )

    pool = Coordinator(num_workers=2, use_processes=True, max_retries=8)
    if warm:
        for _ in range(2):
            pool.schedule(_hostdist_warm)
    return pool


def run_hostdist(torch, cuda, device="cuda", pool=None):
    """Host-side distribution (see the module's docstring): (a) the
    full-width MPMD run through ``run_mpmd_pipeline`` on ``pool``
    (default: one started here), alone; then (b)'s kill run on the same
    pool, (d)'s three runners, this process's ``reference_run`` and (c)'s
    tools side by side.  On the CPU (a rehearsal) the JAX
    test's size runs and the launch checks are left out."""
    import tempfile
    import threading

    from distributedtensorflow_tpu_torch.parallel import pipeline_mpmd as pm

    cuda_dev = device == "cuda"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_hostdist_")
    t0 = time.time()
    failures, out, errors, threads = [], {}, {}, []
    launches = collections.Counter()

    def guarded(name, fn, *a):
        def body():
            try:
                out[name] = fn(*a)
            except BaseException as e:  # noqa: BLE001 — reported below
                errors[name] = repr(e)
        t = threading.Thread(target=body, name=f"hostdist-{name}")
        t.start()
        threads.append(t)

    pool = pool or hostdist_pool()
    try:
        # (a): the full-width MPMD run, the stages process workers, alone
        cfg = _mpmd_config(pm, device)
        logdir = os.path.join(tmp, "mpmd")
        ta = time.time()
        res = pm.run_mpmd_pipeline(cfg, logdir, coordinator=pool,
                                   join_timeout_s=600)
        seconds_a = time.time() - ta
        # (b) on the warm pool (its respawn a process start) beside (d)'s
        # three runners (six process starts), the reference and (c)
        guarded("b", _hostdist_kill, pm, device, tmp, pool)
        guarded("d", _hostdist_children, device)
        guarded("d_terminate", _hostdist_terminate)
        guarded("d_timeout", _hostdist_timeout)
        tr = time.time()
        states = [pm.init_stage_state(cfg, i) for i in range(cfg.n_stages)]
        init_s = time.time() - tr
        ref, trained = pm.reference_run(cfg, states)
        ref_s = time.time() - tr - init_s
        # the first step's batch, before (the run's first loss) and after
        # the run's updates (a loss over freshly drawn batches moves
        # less in 4 steps than from one batch to the next)
        first_after = pm.batch_loss(cfg, trained, 0)
        del trained
        empty_cache(torch, torch.device(device))
        got = res["losses"]
        stages = res["stage_results"]
        want = [_mpmd_launches(cfg, s) for s in range(cfg.n_stages)]
        stage_l = [{k: r["launches"].get(k, 0) for k in want[0]}
                   for r in stages]
        for r in stages:
            launches.update(r["launches"])
        params = [sum(math.prod(s) for s in pm.stage_shapes(
            cfg, i).values()) for i in range(cfg.n_stages)]
        diff = max(abs(a - b) for a, b in zip(got, ref))
        ok_a = (len(got) == cfg.n_steps and got == ref
                and all(math.isfinite(v) for v in got)
                and first_after < got[0]
                and (not cuda_dev or stage_l == want))
        emit({"phase": "hostdist", "part": "mpmd",
              "config": dataclasses.asdict(cfg), "losses": got,
              "losses_in_process": ref, "bit_equal": got == ref,
              "max_abs_diff": diff, "first_batch_loss": [got[0],
                                                         first_after],
              "launches": stage_l, "expected_launches": want,
              "step_ms": [[1e3 * s for s in r["step_seconds"]]
                          for r in stages],
              "median_step_ms_after_first": [
                  1e3 * statistics.median(r["step_seconds"][1:])
                  for r in stages],
              "stage_started_after_s": [r["started_at"] - ta
                                        for r in stages],
              "stage_setup_s": [r["setup_seconds"] for r in stages],
              "stage_params": params, "logits_gb_a_microbatch":
              cfg.microbatch_size * cfg.seq_len * cfg.vocab_size * 4 / 1e9,
              "seconds": seconds_a, "in_process_init_seconds": init_s,
              "in_process_seconds": ref_s, "ok": bool(ok_a)})
        if not ok_a:
            failures.append(f"(a) mpmd: losses {got} against {ref}, the "
                            f"first batch {got[0]} -> {first_after}, "
                            f"launches {stage_l} against {want}")
        row_c = _hostdist_tools(logdir, cfg.n_steps, cfg.n_microbatches)
        emit(row_c)
        if not row_c["ok"]:
            failures.append(f"(c) tools: {row_c}")
        for t in threads:
            t.join(timeout=600)
        failures += [f"({k}) raised {v}" for k, v in errors.items()]
        if "b" in out:
            b = out["b"]
            ok_b = (b["killed"] and len(b["losses"]) == HOSTDIST_KILL_STEPS
                    and b["losses"][-1] < b["losses"][0]
                    and b["stage1_steps"] == list(range(HOSTDIST_KILL_STEPS))
                    and b["requeued"] >= 2 and b["respawns"] == 1)
            emit({"phase": "hostdist", "part": "kill", **b, "ok": ok_b})
            if not ok_b:
                failures.append(f"(b) kill: {b}")
        if {"d", "d_terminate", "d_timeout"} <= set(out):
            d = out["d"]
            kids = d["children"]
            term, late = out["d_terminate"], out["d_timeout"]
            ms = [m for c in kids.values() for m in c["allreduce_ms"]]
            ok_d = (sorted(kids) == [0, 1]
                    and all(c["world"] == 2 and not c["reduce_bad"]
                            and c["gather_equal"] and c["ring_ok"]
                            and c["device"].startswith(device)
                            for c in kids.values())
                    and term["values"] == {0: 0}
                    and term["exit_codes"] == {0: 0, 1: -9}
                    and late is not None and late["exit_codes"][1] == -9)
            emit({"phase": "hostdist", "part": "runner", **d,
                  "terminate": term, "timeout": late,
                  "ring_mib": HOSTDIST_RING_MIB,
                  "ring_allreduce_ms_median": statistics.median(ms),
                  "ring_algbw_gb_s": HOSTDIST_RING_MIB * 2**20 / 1e9
                  / (statistics.median(ms) / 1e3),
                  "ring_note": "the host's loopback TCP on the machine with "
                               "the card, two processes", "ok": ok_d})
            if not ok_d:
                failures.append(f"(d) runner: {d}, {term}, {late}")
    finally:
        for t in threads:
            t.join(timeout=60)
        pool.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "hostdist_seconds", "seconds": time.time() - t0})
    if failures:
        raise AssertionError(f"hostdist: {failures}")
    return launches


PHASES = ("layernorm", "kernels", "xent", "serving", "serve_cli", "train",
          "baseline", "dp", "ckpt", "trainer", "multistep", "presets2",
          "bert_moe", "optim", "records", "dataservice", "jobs", "hostdist",
          "planes", "scaleout", "seqexpert", "pipeline", "splitckpt",
          "splitzero", "quad")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="drive the port on one GPU")
    p.add_argument("--phases", default=",".join(PHASES),
                   help="comma-separated subset of " + ", ".join(PHASES)
                        + " (device and build always run)")
    p.add_argument("--dp-worker", default=None, help=argparse.SUPPRESS)
    p.add_argument("--ckpt-worker", default=None, help=argparse.SUPPRESS)
    p.add_argument("--det-worker", default=None, help=argparse.SUPPRESS)
    p.add_argument("--trainer-worker", default=None, help=argparse.SUPPRESS)
    p.add_argument("--scaleout-worker", default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--split-worker", default=None, help=argparse.SUPPRESS)
    p.add_argument("--quad-worker", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.dp_worker:
        return dp_worker(args.dp_worker)
    if args.ckpt_worker:
        return ckpt_worker(args.ckpt_worker)
    if args.det_worker:
        return det_worker(args.det_worker)
    if args.trainer_worker:
        return trainer_worker(args.trainer_worker)
    if args.scaleout_worker:
        return scaleout_worker(args.scaleout_worker)
    if args.split_worker:
        return split_worker(args.split_worker)
    if args.quad_worker:
        return quad_worker(args.quad_worker)
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
    from distributedtensorflow_tpu_torch import native

    record_lib = native.build_native_library()  # g++, native/src
    emit({"phase": "build", "seconds": time.time() - t0,
          "built": sorted(reports), "record_library": str(record_lib)})
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
    if "serve_cli" in phases:
        import serve_torch

        launches.update(run_serve_cli(torch, _cuda, serve_torch, train_torch,
                                      mods, attn, smi=smi))
        torch.cuda.empty_cache()
    done("serve_cli")
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
    if "trainer" in phases:
        launches.update(run_trainer(torch, _cuda, train_torch, fa))
    done("trainer")
    if "multistep" in phases:
        ms_launches, rows["dropout"] = run_multistep(torch, _cuda,
                                                     train_torch)
        launches.update(ms_launches)
    done("multistep")
    if "presets2" in phases:
        p2_launches, p2_rows = run_presets2(torch, _cuda, train_torch, mods,
                                            attn, ln, F, train_lib)
        launches.update(p2_launches)
        for name, extra in p2_rows.items():
            rows.setdefault(name, []).extend(extra)
    done("presets2")
    if "bert_moe" in phases:
        launches.update(run_bert_moe(torch, _cuda, train_torch))
    done("bert_moe")
    if "optim" in phases:
        launches.update(run_optim(torch, _cuda, train_torch))
    done("optim")
    if "records" in phases:
        run_records(torch, train_torch)
    done("records")
    if "dataservice" in phases:
        launches.update(run_dataservice(torch, _cuda, train_torch))
    done("dataservice")
    # the hostdist phase's process workers import torch and start their
    # CUDA contexts beside the jobs phase, which waits on process starts
    pool = hostdist_pool(warm=True) if "hostdist" in phases else None
    if "jobs" in phases:
        launches.update(run_jobs(torch, _cuda, train_torch))
    done("jobs")
    if "hostdist" in phases:
        launches.update(run_hostdist(torch, _cuda, pool=pool))
    done("hostdist")
    if "planes" in phases:
        import serve_torch

        launches.update(run_planes(torch, _cuda, train_torch, serve_torch,
                                   mods, smi=smi))
    done("planes")
    if "scaleout" in phases:
        launches.update(run_scaleout(torch, _cuda, train_torch, F,
                                     train_row if "train" in phases
                                     else None))
    done("scaleout")
    if "seqexpert" in phases:
        # alone on the card, before the split workers start: its times
        # are not shared
        for name, extra in check_flash_kv_segments(torch, fa).items():
            rows.setdefault(name, []).extend(extra)
    split = [phase for phase in SPLIT_DIRS
             if phase in phases and phase != "splitzero"]
    workers = _start_split_workers(split) if split else []
    # beside the split workers, after every phase that times a kernel:
    # the splitzero phase's own pair and the four-rank group
    zworkers = _start_split_workers(["splitzero"]) \
        if "splitzero" in phases else []
    quad = _start_quad_workers() if "quad" in phases else []
    try:
        if "seqexpert" in phases:
            launches.update(run_seqexpert(
                torch, _cuda, train_torch,
                train_row if "train" in phases else None, workers))
        done("seqexpert")
        if "pipeline" in phases:
            launches.update(run_pipeline(
                torch, _cuda, train_torch,
                train_row if "train" in phases else None, workers))
        done("pipeline")
        if "splitckpt" in phases:
            launches.update(run_splitckpt(torch, _cuda, train_torch,
                                          workers))
        done("splitckpt")
        if "splitzero" in phases:
            launches.update(run_splitzero(torch, _cuda, train_torch,
                                          zworkers))
        done("splitzero")
        if "quad" in phases:
            launches.update(run_quad(torch, _cuda, train_torch, quad))
        done("quad")
        rcs = [p.wait(timeout=300) for p in workers + zworkers]
        if any(rcs):
            raise AssertionError(f"the split workers exited with {rcs}")
    finally:
        for p in workers + zworkers + quad:
            if p.poll() is None:
                p.kill()
                p.wait()
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
        # not a TPU kernel: flax's nn.Dropout in the reference (the rate
        # of the BERT presets)
        "dropout": ("dropout.cu", "models/bert.py:94"),
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
