"""Pipeline-parallel GPT: the GPT LMs' blocks split over the ``pipe``
mesh axis.

Twin of ``distributedtensorflow_tpu/models/gpt_pipeline.py``.
:class:`PipelinedGPT` is the module of one pipe rank: the blocks of its
stages (``layers_per_stage`` :class:`~.gpt.GPTBlock` s a chunk, and
``n_virtual`` chunks for the circular layouts: chunk ``c`` of stage
``p`` is stage ``c*n + p`` of the model, as JAX's ``init`` and
``params_to_dense`` lay them out), named as the dense :class:`~.gpt.GPTLM`
names them (``h.<layer>.*``), and the token table ``wte`` and final
LayerNorm ``ln_f``, which every pipe rank holds.  Stage 0 embeds, the
last stage applies the tied head, and their gradients are summed over
``pipe`` (JAX shards the table's rows over ``pipe``, a placement of the
same values).

The schedule carries are fp32 across the handoffs; a stage casts to
``cfg.dtype`` inside and back to fp32 on the way out, computes its
rotary tables once and applies ``cfg.remat`` per block (``_stage_fn``,
``:318-356``).  The training loss is a ``torch.autograd.Function``
(:class:`_PipelinedLoss`, the twin of JAX's ``custom_vjp`` region
``_build_fb``, ``:447-585``): its forward runs the whole schedule (GPipe
and circular: the forward ticks, the head over the local batch after the
last stage, then the reverse ticks; 1F1B and interleaved: the fused
ticks, the head in the loop on one microbatch at a time) and banks the
parameters' gradients, and its backward hands them out, so the engine's
step, gradient accumulation and clipping run unchanged.  The loss is
summed over ``pipe`` from the last stage, so every rank reports it; over
``data`` x ``fsdp`` (x ``seq``) it is this rank's share, as the dense
model's (``models.gpt.head_loss``).

Quantised compute (``cfg.quant``): the stages' blocks take it as the
dense model's do, each layer's sites numbered as the dense layer's
(:func:`number_stage_sites`); ``int8_stochastic`` rounds with the step's
``DropoutKey`` seed plus the microbatch index, bound before every unit
of that microbatch runs (its recomputation in a backward unit draws the
same bits).  JAX's stages apply their blocks without a ``dropout`` rng,
so its ``int8_stochastic`` rounds with ``PRNGKey(0)`` in every stage:
the two agree in distribution, int8 and fp8 value for value.

The bucketed overlap (``parallel.overlap.OverlapPlan``) sets
``grad_ready``: the schedule hands it each chunk's gradients as soon as
the chunk's last microbatch has run its backward unit.

Composition: over ``model`` the blocks are split by
``parallel.sharding.bind_tensor_parallel`` (the workload's layout leaves
``wte`` whole, as JAX's pipeline layout does); every model rank computes
the whole head, so its seed is the whole cotangent (the port's
tensor-parallel pair ``copy_to_group``/``reduce_from_group`` sums a
gradient where JAX's ``psum`` transposes).  Over ``seq`` (GPipe only)
each stage runs ring or Ulysses attention
(``parallel.ring_attention``) on its rank's slice of the sequence, the
positions offset by ``seq rank x S/n``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops.xent import chunked_softmax_xent, tied_head_logits
from ..parallel import mesh as mesh_lib
from ..parallel.collectives import (
    all_reduce,
    all_reduce_async,
    share_of_mean,
)
from ..parallel.pipeline import (
    SCHEDULES,
    chunk_tensors,
    circular_bubble_fraction,
    fb_schedule,
    gpipe_backward,
    gpipe_bubble_fraction,
    gpipe_forward,
    pipeline_fb_step,
)
from ..parallel.ring_attention import sequence_parallel_attention_fn
from .gpt import GPTBlock, GPTConfig, head_loss, rope_tables, sequence_slice
from .layers import (
    FusedLayerNorm,
    QuantDense,
    bind_quant_seed,
    draw_seed,
    embed_rows,
)


def stage_layers(num_layers: int, n_stages: int, n_virtual: int,
                 stage: int) -> list[list[int]]:
    """The layers of each chunk of pipe rank ``stage``: chunk ``c`` is
    stage ``k = c*n + stage`` of ``n * n_virtual``, layers ``k*lps`` to
    ``(k+1)*lps - 1``."""
    lps = num_layers // (n_stages * n_virtual)
    return [list(range((c * n_stages + stage) * lps,
                       (c * n_stages + stage + 1) * lps))
            for c in range(n_virtual)]


def _wire(handoff_dtype, cfg: GPTConfig):
    """The handoffs' wire dtype (``__post_init__``'s check of it)."""
    if handoff_dtype is None:
        return None
    if handoff_dtype in ("bfloat16", "bf16"):
        if cfg.dtype != torch.bfloat16:
            raise ValueError(
                "handoff_dtype=bfloat16 requires cfg.dtype=bfloat16 — "
                "a bf16 wire under an fp32 model would silently round "
                "every cross-stage residual (with a bf16 model the "
                "cast is exact)")
        return torch.bfloat16
    raise ValueError(f"handoff_dtype must be None or 'bfloat16', "
                     f"got {handoff_dtype!r}")


class PipelinedGPT(nn.Module):
    """One pipe rank of the pipeline-parallel GPT LM over ``mesh``.

    ``n_microbatches`` splits this replica's batch; ``n_virtual > 1``
    selects the circular layouts (GPipe's circular forward order, or the
    ``interleaved`` schedule); ``schedule`` is ``"gpipe"``, ``"1f1b"`` or
    ``"interleaved"``; ``sp_scheme`` the attention over a ``seq`` axis;
    ``handoff_dtype`` None or ``"bfloat16"``, the activations' payload on
    the wire (bit-exact for a bf16 model, which it requires).  The
    checks and messages are JAX's ``__post_init__`` (``:98-236``).
    Parameters live on ``device`` (``cuda`` unless the caller passes
    ``"cpu"``)."""

    def __init__(self, cfg: GPTConfig, mesh, n_microbatches: int, *,
                 n_virtual: int = 1, schedule: str = "gpipe",
                 sp_scheme: str = "ring", handoff_dtype: str | None = None,
                 device=None):
        super().__init__()
        if n_virtual < 1:
            raise ValueError(f"n_virtual must be >= 1, got {n_virtual} "
                             "(--pp-virtual on the CLI)")
        self.seq_parallel = mesh.shape[mesh_lib.AXIS_SEQ] > 1
        if sp_scheme not in ("ring", "ulysses"):
            raise ValueError(
                f"sp_scheme must be ring|ulysses, got {sp_scheme!r}")
        self.n_stages = mesh.shape[mesh_lib.AXIS_PIPE]
        total_stages = self.n_stages * n_virtual
        if cfg.num_layers % total_stages:
            raise ValueError(
                f"num_layers={cfg.num_layers} not divisible by "
                f"pipe={self.n_stages} x n_virtual={n_virtual} stages")
        if n_virtual > 1 and n_microbatches < self.n_stages:
            raise ValueError(
                f"circular schedule needs n_microbatches >= n_stages "
                f"({n_microbatches} < {self.n_stages})")
        if schedule not in SCHEDULES:
            raise ValueError(
                f"schedule must be one of {SCHEDULES}, got {schedule!r}")
        if schedule == "1f1b" and n_virtual != 1:
            raise ValueError(
                "schedule='1f1b' runs one chunk per rank; use "
                "schedule='interleaved' for n_virtual > 1")
        if schedule == "interleaved":
            if n_virtual < 2:
                raise ValueError(
                    "schedule='interleaved' needs n_virtual >= 2 "
                    "(--pp-virtual on the CLI); with one chunk per rank "
                    "use schedule='1f1b'")
            if n_microbatches % self.n_stages:
                raise ValueError(
                    f"interleaved schedule needs n_microbatches a multiple "
                    f"of n_stages ({n_microbatches} vs {self.n_stages})")
        if schedule != "gpipe" and self.seq_parallel:
            raise NotImplementedError(
                "1f1b/interleaved compute the LM-head loss inside the "
                "pipeline region, and the next-token shift crosses seq "
                "shards there — use schedule='gpipe' with sequence "
                "parallelism")
        if cfg.dropout_rate:
            raise NotImplementedError(
                "dropout inside the pipeline needs per-stage rng plumbing; "
                "set dropout_rate=0 for pipeline parallelism")
        self.wire = _wire(handoff_dtype, cfg)
        tp = mesh.shape[mesh_lib.AXIS_MODEL]
        if tp > 1 and (cfg.num_heads % tp or cfg.kv_heads % tp
                       or cfg.intermediate_size % tp):
            raise ValueError(
                f"manual tensor parallelism needs num_heads="
                f"{cfg.num_heads}, kv_heads={cfg.kv_heads} and "
                f"intermediate_size={cfg.intermediate_size} divisible "
                f"by model={tp}")
        device = resolve_device(device)
        self.cfg, self.mesh = cfg, mesh
        self.n_microbatches, self.n_virtual = n_microbatches, n_virtual
        self.schedule, self.sp_scheme = schedule, sp_scheme
        self.handoff_dtype = handoff_dtype
        self.stage = mesh.coords[mesh_lib.AXIS_PIPE]
        self.layers_per_stage = cfg.num_layers // total_stages
        self.attn_fn = sequence_parallel_attention_fn(
            mesh, scheme=sp_scheme, causal=True) if self.seq_parallel \
            else None
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                device=device, dtype=torch.float32)
        layers = stage_layers(cfg.num_layers, self.n_stages, n_virtual,
                              self.stage)
        self.h = nn.ModuleDict({
            str(i): GPTBlock(cfg, device=device, attn_fn=self.attn_fn)
            for chunk in layers for i in chunk})
        self.ln_f = FusedLayerNorm(cfg.hidden_size, out_dtype=torch.float32,
                                   device=device)
        # the chunks' blocks in execution order (a plain list: the blocks
        # are registered once, under ``h``)
        self._chunks = [nn.ModuleList([self.h[str(i)] for i in chunk])
                        for chunk in layers]
        #: ``saved_high`` of the last training pass: the most stage inputs
        #: this rank held at once
        self.last_stats: dict = {}
        #: ``ready(params, grads)`` of an overlap plan, or None
        self.grad_ready = None
        number_stage_sites(self)

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    @property
    def pipe_group(self):
        return self.mesh.pipe_group

    def bubble_fraction(self) -> float:
        if self.schedule in ("1f1b", "interleaved"):
            return self._fb_schedule().bubble_fraction()
        if self.n_virtual > 1:
            return circular_bubble_fraction(
                self.n_stages, self.n_microbatches, self.n_virtual)
        return gpipe_bubble_fraction(self.n_stages, self.n_microbatches)

    def _fb_schedule(self):
        return fb_schedule(
            self.n_stages, self.n_microbatches,
            self.n_virtual if self.schedule == "interleaved" else 1)

    # --- the stage and the head -----------------------------------------

    def _positions(self, s: int, b: int) -> torch.Tensor:
        """Positions of this rank's ``s`` tokens (from ``seq rank x s``
        over a ``seq`` axis) for ``b`` rows."""
        lo = self.mesh.coords[mesh_lib.AXIS_SEQ] * s if self.seq_parallel \
            else 0
        return torch.arange(lo, lo + s, device=self.device).expand(b, s)

    def _stage_fn(self, chunk: nn.ModuleList, x: torch.Tensor):
        """This chunk's blocks on ``x`` (mb, S, D) fp32: ``cfg.dtype``
        inside, fp32 out, the rotary tables once, ``cfg.remat`` per block
        under autograd."""
        cfg = self.cfg
        positions = self._positions(x.shape[1], x.shape[0])
        tabs = rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                           cfg.dtype)
        remat = cfg.remat and torch.is_grad_enabled()
        h = x.to(cfg.dtype)
        for block in chunk:
            if remat:
                h = checkpoint(block, h, positions, tabs, None,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                h = block(h, positions, tabs, None)
        return h.float()

    def _head(self):
        """The tied head's tensors: the table and ``ln_f``."""
        return [self.wte.weight, self.ln_f.scale, self.ln_f.bias]

    def _head_fn(self, head, y, ids_mb):
        """The in-loop loss head of the fb schedules (``_head_fn``,
        ``:433-445``): ``ln_f`` and the chunked tied next-token xent on
        one microbatch, the mean over its tokens."""
        wte, _, _ = head
        h = self.ln_f(y)
        return chunked_softmax_xent(h[:, :-1], wte, ids_mb[:, 1:],
                                    compute_dtype=self.cfg.dtype)

    def _local_ids(self, ids):
        """``(ids, targets)`` of this rank's slice of the sequence: the
        whole rows without a ``seq`` axis (targets the next tokens, the
        last position dropped from the hidden states by the caller)."""
        if not self.seq_parallel:
            return ids, ids[:, 1:]
        n = self.mesh.shape[mesh_lib.AXIS_SEQ]
        rank = self.mesh.coords[mesh_lib.AXIS_SEQ]
        ids, _, targets, _ = sequence_slice(ids, ids[:, 1:], None, rank, n)
        return ids, targets

    def _gpipe_head(self, hidden, targets):
        """The loss of this rank's share (``models.gpt.head_loss``) after
        the last stage, over the whole local batch (``pipelined_lm_loss``,
        ``:697-727``)."""
        hidden = self.ln_f(hidden)
        if not self.seq_parallel:
            hidden = hidden[:, :-1]
        return head_loss(self, chunked_softmax_xent, hidden, targets, None,
                         self.mesh)

    def _microbatches(self, x: torch.Tensor) -> torch.Tensor:
        m = self.n_microbatches
        if x.shape[0] % m:
            raise ValueError(f"per-replica batch {x.shape[0]} not divisible "
                             f"by n_microbatches={m}")
        return x.reshape(m, x.shape[0] // m, *x.shape[1:])

    def _embed(self, ids):
        """Stage 0's fp32 embeddings of ``ids`` (under autograd when it is
        on); zeros of the same shape on the other stages, which read no
        input."""
        if self.stage == 0:
            return embed_rows(self.wte, ids).to(self.cfg.dtype).float()
        return torch.zeros((*ids.shape, self.cfg.hidden_size),
                           device=self.device)

    # --- training ---------------------------------------------------------

    def _quant_seeds(self, generator):
        """``on_unit(m)`` binding microbatch ``m``'s ``int8_stochastic``
        seed (the step's seed plus ``m``), or None without such layers."""
        layers = self.stochastic_quant
        if not layers:
            return None
        seed = 0 if generator is None else draw_seed(generator)
        if isinstance(seed, tuple):
            seed = seed[0] + seed[1]

        def on_unit(m):
            for layer in layers:
                layer.seed = seed + m
        return on_unit

    def _chunk_done(self):
        """The schedule's ``on_chunk_done``: a chunk's banked gradients to
        the overlap plan's sink, or None without one."""
        if self.grad_ready is None:
            return None
        return lambda c, gs: self.grad_ready(chunk_tensors(self._chunks[c]),
                                             gs)

    def _train(self, input_ids, generator=None):
        """One pass of the training schedule: ``(loss, grads)``, the loss
        on every pipe rank and the gradients of ``self.parameters()`` in
        order; ``generator`` (the step's ``DropoutKey``) seeds
        ``int8_stochastic``."""
        group, last = self.pipe_group, self.stage == self.n_stages - 1
        ids, targets = self._local_ids(input_ids)
        on_unit, done = self._quant_seeds(generator), self._chunk_done()
        stats: dict = {}
        with torch.enable_grad():
            x0 = self._embed(ids)
        mb = self._microbatches(x0.detach())
        head = self._head()
        d_head = None  # the head's gradients, on the stage that runs it
        if self.schedule == "gpipe":
            outputs, run = gpipe_forward(self._stage_fn, self._chunks, mb,
                                         group, wire_dtype=self.wire,
                                         stats=stats, on_unit=on_unit)
            loss, g_out = torch.zeros((), device=self.device), None
            if last:
                hidden = outputs.reshape(x0.shape).detach() \
                    .requires_grad_(True)
                with torch.enable_grad():
                    loss = self._gpipe_head(hidden, targets)
                g_out, *d_head = torch.autograd.grad(
                    loss, [hidden, *head], materialize_grads=True)
                g_out = self._microbatches(g_out)
                loss = loss.detach()
            del outputs
            dx0, grads = gpipe_backward(run, g_out, wire_dtype=self.wire,
                                        on_chunk_done=done, on_unit=on_unit)
        else:
            sched = self._fb_schedule()
            share = share_of_mean(1, self.mesh)
            scale = share / self.n_microbatches
            loss_sum, grads, d_head, dx0 = pipeline_fb_step(
                self._stage_fn, self._head_fn, self._chunks, head, mb,
                self._microbatches(ids), sched, group,
                cotangent_scale=scale, wire_dtype=self.wire, stats=stats,
                on_chunk_done=done, on_unit=on_unit)
            loss = loss_sum * scale
        if self.stage == 0:
            (d_embed,) = torch.autograd.grad(x0, [self.wte.weight],
                                             dx0.reshape(x0.shape))
            d_head = [d_embed, None, None] if d_head is None else \
                [d_head[0] + d_embed, *d_head[1:]]
        del x0, dx0, mb
        head_grads = [torch.zeros_like(t) if g is None else g
                      for t, g in zip(head, d_head or [None] * len(head))]
        # the loss and the table's and ln_f's gradients summed over pipe
        # (the loss is the last stage's, the table's the first and the
        # last stages'), each in place
        loss = loss.reshape(1).float()
        for t in (loss, *head_grads):
            work = all_reduce_async(t, group)
            if work is not None:
                work.wait()
        loss = loss[0]
        self.last_stats = stats
        by_id = {id(t): g for t, g in zip(head, head_grads)}
        for chunk, gs in zip(self._chunks, grads):
            by_id.update({id(t): g for t, g in
                          zip(chunk_tensors(chunk), gs)})
        return loss, [by_id[id(p)] for p in self.parameters()]

    # --- forward only -------------------------------------------------------

    def _hidden(self, input_ids):
        """The final hidden states (after ``ln_f``, fp32) of this rank's
        tokens, through the forward-only schedule (GPipe's, or the
        circular forward for ``n_virtual > 1``, whatever ``schedule``
        trains with), on the last stage; None elsewhere."""
        ids, _ = self._local_ids(input_ids)
        bind_quant_seed(self, None)
        with torch.no_grad():
            x0 = self._embed(ids)
            outputs, _ = gpipe_forward(
                self._stage_fn, self._chunks, self._microbatches(x0),
                self.pipe_group, wire_dtype=self.wire, grad=False)
            if self.stage != self.n_stages - 1:
                return None
            return self.ln_f(outputs.reshape(x0.shape))

    def forward(self, input_ids, *, return_hidden: bool = False):
        """Logits (B, S, V) fp32 of this rank's tokens, or the final
        hidden states with ``return_hidden``, on every pipe rank
        (without autograd: the training loss is :func:`pipelined_lm_loss`)."""
        hidden = self._hidden(input_ids)
        with torch.no_grad():
            if hidden is None:
                ids, _ = self._local_ids(input_ids)
                hidden = torch.zeros((*ids.shape, self.cfg.hidden_size),
                                     device=self.device)
            hidden = all_reduce(hidden, self.pipe_group)
            if return_hidden:
                return hidden
            return tied_head_logits(hidden, self.wte.weight, self.cfg.dtype)


class _PipelinedLoss(torch.autograd.Function):
    """The training schedule as one autograd node (JAX's ``custom_vjp``
    region): the forward runs it and banks the gradients, the backward
    scales them by the incoming gradient."""

    @staticmethod
    def forward(ctx, model, input_ids, generator, *params):
        loss, grads = model._train(input_ids, generator)
        ctx.grads = grads
        return loss

    @staticmethod
    def backward(ctx, g):
        grads, ctx.grads = ctx.grads, None
        return (None, None, None, *[x * g for x in grads])


def pipelined_lm_loss(model: PipelinedGPT, group=None):
    """Next-token cross-entropy through the pipeline (``pipelined_lm_loss``,
    ``:697-727``), the chunked tied head: ``loss_fn(batch, generator=None)
    -> (loss, {"log_perplexity": loss})``.  The loss is this rank's share
    over the mesh's gradient group, as ``models.gpt.lm_loss``'s over a
    group (the engine sums the shares; ``group`` is the model's mesh,
    which the model holds), and every pipe rank's; its gradients come
    from the schedule (:class:`_PipelinedLoss`)."""

    def loss_fn(batch, generator=None):
        loss = _PipelinedLoss.apply(model, batch["input_ids"], generator,
                                    *model.parameters())
        return loss, {"log_perplexity": loss.detach()}

    return loss_fn


def pipelined_lm_eval(model: PipelinedGPT, group=None):
    """Eval metric_fn through the forward-only schedule
    (``pipelined_lm_eval``, ``:730-747``): ``{"loss", "log_perplexity"}``,
    this rank's shares as :func:`pipelined_lm_loss`'s, on every pipe
    rank."""

    def metric_fn(batch):
        ids = batch["input_ids"]
        hidden = model._hidden(ids)
        with torch.no_grad():
            loss = torch.zeros((), device=model.device)
            if hidden is not None:
                _, targets = model._local_ids(ids)
                if not model.seq_parallel:
                    hidden = hidden[:, :-1]
                loss = head_loss(model, chunked_softmax_xent, hidden,
                                 targets, None, model.mesh)
            loss = all_reduce(loss, model.pipe_group)
        return {"loss": loss, "log_perplexity": loss}

    return metric_fn


def number_stage_sites(model: PipelinedGPT) -> None:
    """Number a stage's quantisation sites as the dense model's
    (``layers.number_quant_sites`` over ``GPTLM``: every block holds the
    same count of sites, in module order), so layer ``i``'s sites are the
    dense layer ``i``'s wherever it runs; keeps the ``int8_stochastic``
    ones (``model.stochastic_quant``)."""
    layers = []
    for name, block in model.h.items():
        sites = [m for m in block.modules() if isinstance(m, QuantDense)]
        for j, m in enumerate(sites):
            m.site = int(name) * len(sites) + j
        layers += sites
    model.stochastic_quant = [m for m in layers
                              if m.quant == "int8_stochastic"]


def pipeline_modules(cfg: GPTConfig) -> dict[str, str]:
    """Port parameter name -> the first component of its path in JAX's
    pipelined parameter tree (``blocks``, ``ln_f``, ``wte``): the modules
    ``obs.dynamics`` groups a pipelined model's statistics by, as JAX's
    ``cadence_stats`` groups its tree (every stage holds every module)."""
    from .convert import flax_modules

    return {n: "blocks" if n.startswith("h.") else m
            for n, m in flax_modules(cfg).items()}


def params_to_dense(states, cfg: GPTConfig) -> dict:
    """The dense :class:`~.gpt.GPTLM` state from every pipe rank's state
    (``params_to_dense``, ``:750-781``; rank order, each rank's
    ``state_dict()`` or gradients by name): each block from the rank that
    holds it, the table and ``ln_f`` from rank 0 (every rank holds the
    same).  Raises when a layer is missing or held twice."""
    dense: dict = {}
    for rank, state in enumerate(states):
        for name, t in state.items():
            if name.startswith("h.") and name in dense:
                raise ValueError(f"{name} is held by two pipe ranks")
            if name.startswith("h.") or rank == 0:
                dense[name] = t
    held = {int(n.split(".")[1]) for n in dense if n.startswith("h.")}
    if held != set(range(cfg.num_layers)):
        raise ValueError(f"the ranks hold layers {sorted(held)} of "
                         f"{cfg.num_layers}")
    return dense
