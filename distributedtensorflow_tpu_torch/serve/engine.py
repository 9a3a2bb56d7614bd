"""Continuous-batching generation engine: queue -> slots -> paged decode.

Twin of ``distributedtensorflow_tpu/serve/engine.py``, with its keyword
arguments, names and defaults:

- a bounded, thread-safe FIFO queue; a full queue rejects with
  :class:`QueueFullError` (the HTTP front's 429);
- **continuous batching with decode-integrated chunked prefill**: every
  scheduler iteration admits queued requests into free slots, runs at
  most ``prefill_budget`` TOKENS of prefill chunks (budget-bounded
  bursts rotating round-robin across the admitted-but-unfilled requests;
  ``None`` = every pending chunk), then ONE decode step for all decoding
  slots, then evicts finished requests (eos or ``max_new_tokens``).  A
  request's first token is sampled in the iteration its last chunk
  completes (TTFT stops there);
- **paged KV with prefix caching** (``serve.kv_cache``): admission
  reserves the request's worst-case footprint (prompt + max_new), and
  with ``prefix_cache=True`` whole blocks matching an indexed prefix are
  mapped in at refcount + 1, so prefill starts at the first uncached
  chunk.  Completed prompts register their full blocks; released
  registered blocks stay warm in an LRU, evicted only under pressure;
- **admission control**: a request is admitted only when a slot AND its
  whole block reservation are free, strictly in arrival order; an
  oversubscribed pool (``num_blocks`` below full provisioning) is
  absorbed here, never by running out mid-flight;
- **decode fast path**: with ``fused_sampling=True`` sampling runs in the
  decode program (``serve.model.make_fused_decode_fn``) on the model's
  device, per-slot seeds and last tokens stay there, and the host reads
  only a small ``(tokens, counts)`` array an iteration.  With
  ``speculate=K`` an n-gram drafter (``serve.draft``) proposes up to K
  tokens from each request's own history, verified in one multi-token
  pass and accepted by rejection sampling: greedy output equals the
  sequential path's token for token, and an accepted burst emits up to
  K + 1 tokens a slot.  An iteration where no slot drafted runs the
  one-token program;
- **streaming**: a request submitted with ``stream=True`` exposes each
  iteration's committed tokens through an event queue (the HTTP front's
  chunked ``/generatez``).

Sampling on the host (``fused_sampling=False``): greedy, or temperature/
top-k through :func:`serve.sampling.logits_to_probs` and the request's
own ``np.random.default_rng(seed)``, the path whose draws equal JAX's.
The fused sampler draws from Philox keyed by the request's seed, not
JAX's folded keys (``serve.sampling``).

Observability, with JAX's names: the ``serve_ttft_seconds``,
``serve_tpot_seconds``, ``serve_e2e_seconds``, ``serve_batch_occupancy``
and ``serve_decode_tokens_per_step`` histograms; queue, slot and block
gauges (``serve_queue_depth``, ``serve_active_slots``,
``serve_kv_blocks_free``, ``serve_kv_blocks_cached``,
``serve_kv_block_refs``, ``serve_kv_fragmentation``,
``serve_prefix_cache_occupancy``, ``serve_prefix_hit_rate``); the
counters ``serve_requests_total{status=}``,
``serve_tokens_generated_total``, ``serve_admits_total{reused=}``,
``serve_prefix_hits_total``, ``serve_prefix_cached_tokens_total``,
``serve_prefill_tokens_total``, ``serve_prefix_evictions_total``,
``serve_kv_cow_copies_total``, ``serve_spec_drafted_total`` and
``serve_spec_accepted_total``.  With a ``logdir``: ``requests.jsonl``
(ok rows carry ``cached_prefix_tokens + prefill_tokens ==
prompt_tokens``, the draft split, and the exclusive ``attr_*`` split of
``e2e_s``), ``metrics.jsonl`` rows and ``metrics.prom`` snapshots,
``steps.jsonl`` (one record per iteration that did work, also in a
bounded ring: :meth:`Engine.step_records`, ``GET /stepz``),
``usage.jsonl`` (``obs.usage``), and queue/prefill/decode spans in the
installed ``obs.tracing.TraceRecorder``'s ``trace.jsonl``.

Threading: callers on any thread only touch :meth:`Engine.submit`
(queue and lock); the device work and all ``PagedKVCache`` changes
happen on the single loop thread (:meth:`Engine.start`), or on the
caller's thread when tests drive :meth:`Engine.step` directly.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import math
import os
import queue
import threading
import time

import numpy as np
import torch

from ..models.gpt import GPTLM
from ..obs import registry as obs_registry
from ..obs import tracing as obs_tracing
from ..obs import usage as obs_usage
from ..utils.metrics import json_sanitize
from . import draft as spec_draft
from . import sampling
from .kv_cache import PagedKVCache
from .model import (
    make_decode_fn,
    make_fused_decode_fn,
    make_gather_cache_fn,
    make_prefill_fn,
    reset_cache_index,
)

__all__ = ["Engine", "GenRequest", "QueueFullError"]


class QueueFullError(RuntimeError):
    """Raised by :meth:`Engine.submit` when the bounded queue is full."""


# eq=False: requests are live objects; membership tests need identity
@dataclasses.dataclass(eq=False)
class GenRequest:
    """One generation request plus its lifecycle bookkeeping."""

    id: str
    prompt: list[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    eos_token_id: int | None = None
    seed: int = 0
    #: tracing id (client-supplied or generated at submit) that the
    #: queue/prefill/decode spans carry
    trace_id: str = ""
    #: validated tenant (``obs.usage.validate_tenant``): the key of every
    #: requests.jsonl row, step-log admission and usage integral
    tenant: str = obs_usage.DEFAULT_TENANT
    #: absolute wall deadline (0 = none): a request still queued past it
    #: is abandoned at admission
    t_deadline: float = 0.0
    deadline_exceeded: bool = False

    # -- lifecycle (engine-owned) --
    status: str = "queued"            # queued/active/ok/rejected/error
    finish_reason: str | None = None  # "eos" | "length"
    error: str | None = None
    tokens: list[int] = dataclasses.field(default_factory=list)
    slot: int | None = None
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    occ_sum: int = 0
    occ_steps: int = 0
    occ_max: int = 0
    #: prompt tokens mapped from the prefix cache at admission and those
    #: owed to prefill compute; they sum to ``len(prompt)``
    cached_prefix_tokens: int = 0
    prefill_tokens: int = 0
    #: worst inter-token latency (the stall the prefill budget bounds)
    itl_max_s: float = 0.0
    #: draft tokens proposed for this request and accepted by the
    #: verifier (``accepted <= drafted``; 0 without speculation)
    drafted: int = 0
    accepted: int = 0
    #: the request's e2e split into EXCLUSIVE wall components charged on
    #: the engine thread: own prefill, interference stall (other
    #: requests' prefill while this one was runnable), decode dispatches
    #: (plain / speculative), scheduler gap; with the queue wait they sum
    #: to ``e2e_s``.  ``_t_attr`` is the charging frontier.
    attr_prefill_s: float = 0.0
    attr_stall_s: float = 0.0
    attr_decode_s: float = 0.0
    attr_spec_s: float = 0.0
    attr_gap_s: float = 0.0
    _t_attr: float = 0.0
    #: streaming: ("tokens", [ids]) events per iteration and one terminal
    #: ("done", None); None for a blocking request
    _events: queue.Queue | None = dataclasses.field(default=None, repr=False)
    # -- chunked-prefill state (engine thread only) --
    _fill_buf: np.ndarray | None = dataclasses.field(default=None,
                                                     repr=False)
    _fill_next: int = 0               # next chunk's first absolute position
    _fill_pad: int = 0                # padded prefill extent
    _prefill_done: bool = False
    _t_last_token: float = 0.0
    _done: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False)
    _rng: np.random.Generator | None = dataclasses.field(default=None,
                                                         repr=False)

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the request reaches a terminal state."""
        return self._done.wait(timeout)

    @property
    def ttft_s(self) -> float:
        return max(self.t_first_token - self.t_submit, 0.0)

    @property
    def e2e_s(self) -> float:
        return max(self.t_done - self.t_submit, 0.0)

    @property
    def tpot_s(self) -> float:
        """Mean per-output-token latency after the first token."""
        if len(self.tokens) <= 1:
            return 0.0
        return max(self.t_done - self.t_first_token, 0.0) / (
            len(self.tokens) - 1)


class Engine:
    """Continuous-batching scheduler over the serving programs
    (``serve.model``) of ``model``, on the model's device.  Construct,
    :meth:`start`, :meth:`submit` from any thread, :meth:`stop` to
    drain; or drive :meth:`step` synchronously."""

    def __init__(
        self,
        model: GPTLM,
        *,
        max_slots: int = 4,
        max_queue: int = 64,
        block_size: int = 16,
        num_blocks: int | None = None,
        prefill_chunk: int = 16,
        prefill_budget: int | None = None,
        prefix_cache: bool = False,
        fused_sampling: bool = False,
        speculate: int = 0,
        spec_ngram: int = 3,
        max_context: int | None = None,
        max_new_cap: int | None = None,
        logdir: str | None = None,
        log_every: int = 50,
        step_ring: int = 512,
        registry=None,
    ):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        cfg = model.cfg
        max_context = max_context or cfg.max_seq
        if max_context % block_size:
            raise ValueError(
                f"max_context={max_context} must be a multiple of "
                f"block_size={block_size}")
        if not 0 < prefill_chunk <= max_context:
            raise ValueError(
                f"prefill_chunk={prefill_chunk} must be in "
                f"[1, max_context={max_context}]")
        if prefill_budget is not None and prefill_budget < 1:
            raise ValueError(
                f"prefill_budget={prefill_budget} must be >= 1 tokens "
                "(None = unbudgeted)")
        speculate = int(speculate)
        if speculate < 0:
            raise ValueError(f"speculate={speculate} must be >= 0")
        if speculate and not fused_sampling:
            raise ValueError("speculate requires fused_sampling=True")
        if speculate and spec_ngram < 1:
            raise ValueError(f"spec_ngram={spec_ngram} must be >= 1")
        self.model = model
        self.device = model.device
        self.cfg = dataclasses.replace(cfg, max_seq=max_context)
        self.max_slots = max_slots
        self.max_queue = max_queue
        self.max_new_cap = max_new_cap
        self.prefill_chunk = prefill_chunk
        self.prefill_budget = prefill_budget
        self.prefix_cache = bool(prefix_cache)
        self.logdir = logdir
        self.log_every = max(int(log_every), 1)
        if num_blocks is None:
            # full provisioning: every slot can hold max_context; fewer
            # oversubscribe, and admission control absorbs the pressure
            num_blocks = max_slots * (max_context // block_size)
        self.kv = PagedKVCache(
            num_layers=cfg.num_layers, kv_heads=cfg.kv_heads,
            head_dim=cfg.head_dim, max_slots=max_slots,
            num_blocks=num_blocks, block_size=block_size,
            max_context=max_context, dtype=cfg.dtype, device=self.device,
        )
        self._prefill = make_prefill_fn(self.cfg, chunk=prefill_chunk,
                                        block_size=block_size)
        self._decode = make_decode_fn(self.cfg)
        self.fused_sampling = bool(fused_sampling)
        self.speculate = speculate
        self.spec_ngram = int(spec_ngram)
        self._fused1 = None
        self._fused_spec = None
        dev = self.device
        if self.fused_sampling:
            # the one-token program always, the T = K + 1 verify program
            # with speculation: an iteration where no slot drafted runs
            # the one-token program
            self._fused1 = make_fused_decode_fn(
                self.cfg, block_size=block_size, draft=0)
            if self.speculate:
                self._fused_spec = make_fused_decode_fn(
                    self.cfg, block_size=block_size, draft=self.speculate)
        # device-resident sampling state: each slot's last sampled token
        # (the (B, 1) feed) and its request's seed
        self._dev_tokens = torch.zeros((max_slots, 1), dtype=torch.int64,
                                       device=dev)
        self._dev_seeds = torch.zeros((max_slots,), dtype=torch.int64,
                                      device=dev)
        # per-slot inputs that change only with the slot set (admission,
        # prefill completion, eviction), re-sent behind a dirty flag; the
        # page tables behind the cache's version
        self._slot_meta_dirty = True
        self._active_arr = np.zeros((max_slots,), bool)
        self._dev_active = None
        self._dev_temp = None
        self._dev_topk = None
        self._dev_prompt_lens = None
        self._all_greedy = True
        self._dev_zero_drafts = torch.zeros((max_slots,), dtype=torch.int64,
                                            device=dev)
        self._dev_tables = None
        self._dev_tables_version = -1
        self._gather = make_gather_cache_fn(self.cfg, block_size=block_size)
        self._prefill_cache = model.init_cache(1, max_context)
        #: (slot, pos): the dense prefill cache holds that slot's K/V for
        #: positions [0, pos), so its next chunk skips the pool gather
        self._prefill_cache_state: tuple[int, int] | None = None

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: collections.deque[GenRequest] = collections.deque()
        self._ids = itertools.count()
        self._slots: list[GenRequest | None] = [None] * max_slots
        self._slot_reused = [False] * max_slots
        #: admitted requests whose prefill has not finished, round-robin
        #: order (entries are also in _slots)
        self._filling: collections.deque[GenRequest] = collections.deque()
        self._last_tokens = np.zeros((max_slots,), np.int64)
        self._thread: threading.Thread | None = None
        self._stop_flag = False
        self._crashed: str | None = None
        self._stopped = False
        self.decode_steps = 0
        self.occupancy_max = 0
        self.prefill_iters = 0   # iterations that ran >= 1 prefill chunk
        self.prefill_chunks = 0
        #: iterations where the budget ran out with fillers still pending
        self.prefill_budget_stalls = 0
        self.step_ring_size = max(int(step_ring), 1)
        self._step_ring: collections.deque = collections.deque(
            maxlen=self.step_ring_size)
        self._step_id = 0
        self._step_evicted = 0
        self._iter_prefill_s = 0.0
        self._iter_device_s = 0.0
        self._prefill_stalled = False
        # prefix lookups/hits/cached tokens live on the PagedKVCache
        self.counters = {
            "submitted": 0, "ok": 0, "rejected": 0, "error": 0,
            "tokens_generated": 0, "admits": 0, "admits_into_freed_slot": 0,
            "prefill_tokens": 0,
            # the decode fast path: committed tokens, drafts and their
            # acceptances, program calls and host sampling rounds
            "decode_tokens": 0, "spec_drafted": 0, "spec_accepted": 0,
            "decode_dispatches": 0, "host_sample_rounds": 0,
            # active slots summed over decode steps: tokens-per-step's
            # per-slot denominator
            "slot_steps": 0,
        }

        reg = registry or obs_registry.default_registry()
        self._m_ttft = reg.histogram(
            "serve_ttft_seconds", "request arrival -> first token")
        self._m_tpot = reg.histogram(
            "serve_tpot_seconds", "mean per-output-token latency")
        self._m_e2e = reg.histogram(
            "serve_e2e_seconds", "request arrival -> completion")
        self._m_occ = reg.histogram(
            "serve_batch_occupancy", "active slots per decode step",
            buckets=tuple(float(i) for i in range(1, max_slots + 1)))
        self._m_queue = reg.gauge("serve_queue_depth", "queued requests")
        self._m_active = reg.gauge("serve_active_slots", "occupied slots")
        self._m_blocks_free = reg.gauge(
            "serve_kv_blocks_free", "free KV pool blocks")
        self._m_blocks_cached = reg.gauge(
            "serve_kv_blocks_cached",
            "refcount-0 prefix-cached KV blocks (evictable)")
        self._m_block_refs = reg.gauge(
            "serve_kv_block_refs",
            "sum of block refcounts (> used blocks = sharing live)")
        self._m_frag = reg.gauge(
            "serve_kv_fragmentation",
            "internal fragmentation of allocated KV blocks [0,1]")
        self._m_prefix_occ = reg.gauge(
            "serve_prefix_cache_occupancy",
            "share of the pool holding indexed prefix content [0,1]")
        self._m_prefix_rate = reg.gauge(
            "serve_prefix_hit_rate",
            "admissions that mapped >=1 cached prefix block [0,1]")
        self._m_requests = reg.counter(
            "serve_requests_total", "terminal requests by status")
        self._m_tokens = reg.counter(
            "serve_tokens_generated_total", "generated tokens")
        self._m_admits = reg.counter(
            "serve_admits_total", "admissions (reused=slot had served before)")
        self._m_prefix_hits = reg.counter(
            "serve_prefix_hits_total",
            "admissions that mapped >=1 cached prefix block")
        self._m_prefix_tokens = reg.counter(
            "serve_prefix_cached_tokens_total",
            "prompt tokens served from the prefix cache (no prefill)")
        self._m_prefill_tokens = reg.counter(
            "serve_prefill_tokens_total",
            "prompt tokens owed to prefill compute (uncached)")
        self._m_evictions = reg.counter(
            "serve_prefix_evictions_total",
            "cached blocks evicted under pool pressure")
        self._m_cow = reg.counter(
            "serve_kv_cow_copies_total", "copy-on-write block copies")
        self._m_spec_drafted = reg.counter(
            "serve_spec_drafted_total",
            "draft tokens proposed to the speculative verifier")
        self._m_spec_accepted = reg.counter(
            "serve_spec_accepted_total",
            "draft tokens accepted by the verifier (always <= drafted)")
        self._m_tok_step = reg.histogram(
            "serve_decode_tokens_per_step",
            "tokens committed per slot per decode step (1 without "
            "speculation; up to speculate+1 with an accepted burst)",
            buckets=tuple(float(i)
                          for i in range(1, max(self.speculate, 1) + 2)))
        self._last_evictions = 0
        self._last_cow = 0
        self._registry = reg

        self._req_log = None
        self._met_log = None
        self._step_log = None
        self._log_lock = threading.Lock()
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            self._req_log = open(os.path.join(logdir, "requests.jsonl"), "a")
            self._met_log = open(os.path.join(logdir, "metrics.jsonl"), "a")
            self._step_log = open(os.path.join(logdir, "steps.jsonl"), "a")
        # the per-tenant ledger, fed from the loop thread with the step
        # log's own wall and post-eviction census
        self.usage = obs_usage.UsageMeter(
            registry=reg, logdir=logdir,
            token_flops=obs_usage.estimate_token_flops(self.cfg),
            device_kind=(torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else dev.type),
            max_slots=max_slots,
            kv_blocks_total=self.kv.allocator.num_blocks,
            flush_every=log_every,
        )

    # -- submission (any thread) ---------------------------------------------

    def submit(
        self,
        prompt,
        *,
        max_new_tokens: int,
        temperature: float = 0.0,
        top_k: int = 0,
        eos_token_id: int | None = None,
        seed: int = 0,
        trace_id: str | None = None,
        tenant: str | None = None,
        deadline_s: float | None = None,
        stream: bool = False,
    ) -> GenRequest:
        """Validate and enqueue; returns the live :class:`GenRequest`.
        Raises ``ValueError`` on a malformed request (400),
        :class:`QueueFullError` when the queue is full (429) and
        ``RuntimeError`` once the engine is stopped or its loop died
        (503)."""
        if self._crashed is not None:
            raise RuntimeError(f"engine loop dead: {self._crashed}")
        if self._stopped:
            raise RuntimeError("engine stopped")
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("prompt must be a non-empty token list")
        if any(t < 0 or t >= self.cfg.vocab_size for t in prompt):
            raise ValueError(
                f"prompt tokens must be in [0, {self.cfg.vocab_size})")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        # validated here, not on the loop thread: a bad value must 400
        # one request, never kill the loop
        temperature = float(temperature)
        if not math.isfinite(temperature) or temperature < 0.0:
            raise ValueError(
                f"temperature must be a finite number >= 0, got {temperature}")
        top_k = int(top_k)
        if not 0 <= top_k <= self.cfg.vocab_size:
            raise ValueError(
                f"top_k must be in [0, {self.cfg.vocab_size}], got {top_k}")
        if self.max_new_cap and max_new_tokens > self.max_new_cap:
            raise ValueError(
                f"max_new_tokens {max_new_tokens} exceeds the server cap "
                f"{self.max_new_cap}")
        if eos_token_id is not None and not (
                0 <= eos_token_id < self.cfg.vocab_size):
            raise ValueError(f"bad eos_token_id {eos_token_id}")
        if trace_id is not None:
            trace_id = str(trace_id)
            if not 1 <= len(trace_id) <= 64:
                raise ValueError(
                    f"trace_id must be 1..64 characters, got "
                    f"{len(trace_id)}")
        tenant = obs_usage.validate_tenant(tenant)
        if deadline_s is not None:
            deadline_s = float(deadline_s)
            if not math.isfinite(deadline_s) or deadline_s <= 0:
                raise ValueError(
                    f"deadline_s must be a finite number > 0, got "
                    f"{deadline_s}")
        # the footprint does not depend on a prefix hit (the chunk grid
        # stays anchored at 0), so it is checked here
        footprint = self._footprint(len(prompt), max_new_tokens)
        if footprint > self.kv.max_context:
            raise ValueError(
                f"request footprint {footprint} tokens (prompt "
                f"{len(prompt)} padded to the {self.prefill_chunk}-token "
                f"prefill chunk, + {max_new_tokens} new) exceeds "
                f"max_context={self.kv.max_context}")
        # a request the WHOLE pool cannot hold would wedge the FIFO head
        if self.kv.blocks_for(footprint) > self.kv.allocator.num_blocks:
            raise ValueError(
                f"request footprint {footprint} tokens needs "
                f"{self.kv.blocks_for(footprint)} KV blocks but the pool "
                f"has {self.kv.allocator.num_blocks}")
        req = GenRequest(
            id=f"r{next(self._ids)}", prompt=prompt,
            max_new_tokens=int(max_new_tokens), temperature=temperature,
            top_k=top_k, eos_token_id=eos_token_id, seed=int(seed),
            trace_id=trace_id or obs_tracing.new_trace_id(),
            tenant=tenant, t_submit=time.time(),
        )
        if deadline_s is not None:
            req.t_deadline = req.t_submit + deadline_s
        if stream:
            req._events = queue.Queue()
        req._rng = np.random.default_rng(req.seed)
        rejected = False
        with self._cond:
            if self._stopped or self._stop_flag or self._crashed is not None:
                raise RuntimeError("engine stopped")
            if len(self._queue) >= self.max_queue:
                rejected = True
                req.status = "rejected"
                req.t_done = time.time()
                req._done.set()
                self.counters["rejected"] += 1
                self._m_requests.inc(status="rejected")
            else:
                self.counters["submitted"] += 1
                self._queue.append(req)
                self._m_queue.set(len(self._queue))
                self._cond.notify()
        if rejected:
            # the log write happens outside the scheduler lock
            self._log_request(req)
            self.usage.on_finish(req)
            raise QueueFullError(
                f"queue full ({self.max_queue} requests waiting)")
        return req

    def generate(self, prompt, *, timeout: float | None = None,
                 **kwargs) -> GenRequest:
        """Blocking convenience: submit and wait (needs :meth:`start`)."""
        req = self.submit(prompt, **kwargs)
        if not req.wait(timeout):
            raise TimeoutError(f"request {req.id} still running")
        return req

    # -- scheduler (engine thread) -------------------------------------------

    def _to_dev(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(self.device)

    def _refresh_slot_meta(self) -> None:
        """Re-send the per-slot active mask and sampling parameters after
        a slot-set change."""
        if not self._slot_meta_dirty:
            return
        for i, r in enumerate(self._slots):
            self._active_arr[i] = r is not None and r._prefill_done
        self._dev_active = self._to_dev(self._active_arr.copy())
        if self.fused_sampling:
            self._dev_temp = self._to_dev(np.array(
                [0.0 if r is None else r.temperature for r in self._slots],
                np.float32))
            self._dev_topk = self._to_dev(np.array(
                [0 if r is None else r.top_k for r in self._slots],
                np.int64))
            self._dev_prompt_lens = self._to_dev(np.array(
                [0 if r is None else len(r.prompt) for r in self._slots],
                np.int64))
            self._all_greedy = all(r is None or r.temperature <= 0.0
                                   for r in self._slots)
        self._slot_meta_dirty = False

    def _tables_dev(self) -> torch.Tensor:
        """Device copy of the page tables, re-sent only when a table
        changed (``PagedKVCache.tables_version``)."""
        if self._dev_tables_version != self.kv.tables_version:
            self._dev_tables = self._to_dev(
                self.kv.block_tables.astype(np.int64))
            self._dev_tables_version = self.kv.tables_version
        return self._dev_tables

    def _seq_lens_dev(self) -> torch.Tensor:
        return self._to_dev(self.kv.seq_lens.astype(np.int64))

    def _padded_prompt_len(self, prompt_len: int) -> int:
        """Prompt length rounded up to whole prefill chunks: the extent
        the prefill program writes K/V through, pad positions included."""
        c = self.prefill_chunk
        return -(-prompt_len // c) * c

    def _footprint(self, prompt_len: int, max_new: int) -> int:
        """Worst-case KV positions a request can touch."""
        return max(self._padded_prompt_len(prompt_len), prompt_len + max_new)

    @torch.no_grad()
    def step(self) -> bool:
        """One scheduler iteration: admit -> budgeted prefill -> decode ->
        evict.  Returns True when any work happened; such an iteration
        leaves one step-log record."""
        t0 = time.time()
        tokens0 = self.counters["decode_tokens"]
        drafted0 = self.counters["spec_drafted"]
        accepted0 = self.counters["spec_accepted"]
        self._step_evicted = 0
        self._iter_device_s = 0.0
        admitted = self._admit_from_queue()
        t1 = time.time()
        chunks = self._run_prefill_budget()
        t2 = time.time()
        self._iter_prefill_s = t2 - t1
        occupancy = sum(r is not None and r._prefill_done
                        for r in self._slots)
        if occupancy:
            self._run_decode_step()
        t3 = time.time()
        did = bool(admitted or chunks or occupancy)
        if did:
            # the post-eviction census at t3, the slot set the step
            # record's active_slots reflects
            held = [(r, self.kv.billed_blocks(i))
                    for i, r in enumerate(self._slots) if r is not None]
            self._log_step(
                t0, t1, t2, t3, admitted, chunks, occupancy,
                self.counters["decode_tokens"] - tokens0,
                self.counters["spec_drafted"] - drafted0,
                self.counters["spec_accepted"] - accepted0,
                sum(b for _, b in held))
            self.usage.on_step(t3, t3 - t0, held, self._step_id)
        if did and self.decode_steps % self.log_every == 0:
            self._log_metrics_row()
        return did

    def _log_step(self, t0: float, t1: float, t2: float, t3: float,
                  admitted: list[GenRequest], chunks: int, occupancy: int,
                  tokens: int, drafted: int, accepted: int,
                  blocks_billed: float) -> None:
        """One record for the iteration that just ran: phase mix,
        occupancy, token deltas, and the wall split (admit/prefill/decode
        and the share spent in the serving programs)."""
        phases = []
        if admitted:
            phases.append("admit")
        if chunks:
            phases.append("prefill")
        if occupancy:
            phases.append("decode")
        self._step_id += 1
        device_s = min(self._iter_device_s, t3 - t0)
        rec = {
            "t": t3,
            "step": self._step_id,
            "phase": "+".join(phases) or "idle",
            "occupancy": occupancy,
            "active_slots": sum(r is not None for r in self._slots),
            "filling_slots": len(self._filling),
            "queue_depth": len(self._queue),
            "admitted": len(admitted),
            "evicted": self._step_evicted,
            "prefill_chunks": chunks,
            "budget_stall": int(self._prefill_stalled),
            "tokens_committed": tokens,
            "spec_drafted": drafted,
            "spec_accepted": accepted,
            "admit_s": round(t1 - t0, 6),
            "prefill_s": round(t2 - t1, 6),
            "decode_s": round(t3 - t2, 6),
            "step_s": round(t3 - t0, 6),
            "device_s": round(device_s, 6),
            "host_s": round(max((t3 - t0) - device_s, 0.0), 6),
            "kv_blocks_billed": round(blocks_billed, 4),
        }
        if admitted:
            by_tenant: dict[str, int] = {}
            for r in admitted:
                by_tenant[r.tenant] = by_tenant.get(r.tenant, 0) + 1
            rec["admitted_tenants"] = by_tenant
        with self._log_lock:
            self._step_ring.append(rec)
            if self._step_log is None:
                return
            self._step_log.write(json.dumps(json_sanitize(rec)) + "\n")
            self._step_log.flush()

    def step_records(self, n: int | None = None) -> list[dict]:
        """The newest ``n`` step-log records (all retained ones when
        ``n`` is None): the ``GET /stepz`` tail."""
        with self._log_lock:
            recs = list(self._step_ring)
        return recs[-n:] if n else recs

    @property
    def steps_total(self) -> int:
        """Step-log records emitted over the engine's lifetime."""
        return self._step_id

    def _admit_from_queue(self) -> list[GenRequest]:
        """Strict FIFO: pop the head only while a slot AND its whole
        (prefix-discounted) block reservation fit; a head past its
        deadline is abandoned."""
        admitted = []
        expired: list[GenRequest] = []
        with self._cond:
            while self._queue:
                head = self._queue[0]
                if head.t_deadline and time.time() > head.t_deadline:
                    self._queue.popleft()
                    head.deadline_exceeded = True
                    head.error = (
                        f"deadline exceeded after "
                        f"{time.time() - head.t_submit:.3f}s in queue")
                    expired.append(head)
                    continue
                free = [i for i, r in enumerate(self._slots) if r is None]
                if not free:
                    break
                slot = free[0]
                pages = self.kv.admit(
                    slot, self._footprint(len(head.prompt),
                                          head.max_new_tokens),
                    prompt=head.prompt if self.prefix_cache else None)
                if pages is None:  # pool pressure
                    break
                self._queue.popleft()
                p = pages.prefix_tokens
                head.cached_prefix_tokens = p
                head.prefill_tokens = len(head.prompt) - p
                head.slot = slot
                head.status = "active"
                head.t_admit = time.time()
                head._t_attr = head.t_admit
                # the chunk grid stays anchored at 0: prefill starts at
                # the last chunk boundary <= the first uncached token
                head._fill_buf = np.zeros(
                    (self._padded_prompt_len(len(head.prompt)),), np.int64)
                head._fill_buf[:len(head.prompt)] = head.prompt
                head._fill_pad = len(head._fill_buf)
                head._fill_next = (p // self.prefill_chunk) \
                    * self.prefill_chunk
                self._slots[slot] = head
                self._slot_meta_dirty = True
                if self.fused_sampling:
                    self._dev_seeds[slot] = sampling.seed_word(head.seed)
                if self._prefill_cache_state is not None \
                        and self._prefill_cache_state[0] == slot:
                    # never alias the previous tenant's dense cache
                    self._prefill_cache_state = None
                self._filling.append(head)
                reused = self._slot_reused[slot]
                self._slot_reused[slot] = True
                self.counters["admits"] += 1
                if reused:
                    self.counters["admits_into_freed_slot"] += 1
                self._m_admits.inc(reused=str(reused).lower())
                if p:
                    self._m_prefix_hits.inc()
                    self._m_prefix_tokens.inc(p)
                self.counters["prefill_tokens"] += head.prefill_tokens
                self._m_prefill_tokens.inc(head.prefill_tokens)
                admitted.append(head)
            self._m_queue.set(len(self._queue))
        for req in expired:
            self._finish(req, None, status="error")
        self._m_active.set(sum(r is not None for r in self._slots))
        self._update_kv_metrics()
        for req in admitted:
            self.usage.on_admit(req)
        return admitted

    def _run_prefill_budget(self) -> int:
        """At most ``prefill_budget`` tokens of prefill chunks, in bursts
        round-robin across the filling requests: the head runs
        consecutive chunks (the dense-cache fast path) until it finishes
        or the budget runs out, then rotates to the back.  At least one
        chunk runs when any request is filling.  Returns the chunk
        count."""
        if not self._filling:
            self._prefill_stalled = False
            return 0
        budget = self.prefill_budget
        spent = 0
        chunks = 0
        while self._filling and (budget is None or spent < budget):
            req = self._filling.popleft()
            done = False
            while True:
                last_logits = self._run_prefill_chunk(req)
                spent += self.prefill_chunk
                chunks += 1
                if req._fill_next >= req._fill_pad:
                    self._finish_prefill(req, last_logits)
                    done = True
                    break
                if budget is not None and spent >= budget:
                    break
            if not done:
                self._filling.append(req)
        self.prefill_iters += 1
        self.prefill_chunks += chunks
        self._prefill_stalled = bool(self._filling)
        if self._prefill_stalled:
            self.prefill_budget_stalls += 1
        return chunks

    def _run_prefill_chunk(self, req: GenRequest) -> torch.Tensor:
        """One fixed-width chunk of one request.  The dense prefill cache
        is rebuilt from the slot's pool blocks unless it already holds
        exactly this slot's K/V up to the chunk start."""
        slot = req.slot
        c = self.prefill_chunk
        start = req._fill_next
        t_chunk0 = time.time()
        # everything since the frontier went to other requests' work
        req.attr_stall_s += max(t_chunk0 - req._t_attr, 0.0)
        table_row = self.kv.block_tables[slot]
        if self._prefill_cache_state != (slot, start):
            if start:
                self._gather(self.kv.k_pool, self.kv.v_pool,
                             self._prefill_cache, table_row, start)
            else:
                reset_cache_index(self._prefill_cache)
        last_ix = min(max(len(req.prompt) - 1 - start, 0), c - 1)
        tokens = self._to_dev(req._fill_buf[None, start:start + c])
        last_logits = self._prefill(
            self.model, self.kv.k_pool, self.kv.v_pool, self._prefill_cache,
            tokens, start, table_row, last_ix)
        req._fill_next = start + c
        self._prefill_cache_state = (slot, start + c)
        self.kv.note_written(
            slot, max(min(start + c, len(req.prompt)),
                      int(self.kv.seq_lens[slot])))
        t_chunk1 = time.time()
        req.attr_prefill_s += max(t_chunk1 - t_chunk0, 0.0)
        req._t_attr = t_chunk1
        self._iter_device_s += t_chunk1 - t_chunk0
        return last_logits

    def _finish_prefill(self, req: GenRequest, last_logits) -> None:
        """The last chunk completed: index the prompt's full blocks,
        sample the first token (TTFT stops here) and hand the slot to the
        decode batch."""
        if self.prefix_cache:
            self.kv.register_prefix(req.slot, req.prompt)
        req._prefill_done = True
        self._slot_meta_dirty = True
        t_sample0 = time.time()
        if self.fused_sampling:
            # the device sampler's math and key schedule (emitted
            # position 0): one sampling stream across prefill and decode
            tok = sampling.sample_one(last_logits, req.seed, 0,
                                      req.temperature, req.top_k)
            self._dev_tokens[req.slot, 0] = tok
        else:
            tok = self._sample(req, last_logits.cpu().numpy())
        req.t_first_token = time.time()
        req._t_last_token = req.t_first_token
        # the sample waits for the last chunk: the tail of this request's
        # prefill, for the attribution and the step's device share
        req.attr_prefill_s += max(req.t_first_token - req._t_attr, 0.0)
        req._t_attr = req.t_first_token
        self._iter_device_s += req.t_first_token - t_sample0
        req.tokens.append(tok)
        self.usage.on_tokens(req, 1)
        self._last_tokens[req.slot] = tok
        self._m_ttft.observe(req.ttft_s)
        self._stream_emit(req, [tok])
        self._maybe_finish(req)

    def _run_decode_step(self) -> None:
        """One decode iteration for every slot whose prefill is done: the
        host-sampling path, or the fused path."""
        decoding = [(i, r) for i, r in enumerate(self._slots)
                    if r is not None and r._prefill_done]
        n_active = len(decoding)
        if self.fused_sampling:
            self._decode_step_fused(decoding, n_active)
            return
        t_dec0 = time.time()
        for i, _ in decoding:
            # copy-on-write guard; a no-op in the steady state
            self.kv.ensure_writable(i, int(self.kv.seq_lens[i]))
        self._refresh_slot_meta()
        logits = self._decode(
            self.model, self.kv.k_pool, self.kv.v_pool,
            self._to_dev(self._last_tokens), self._tables_dev(),
            self._seq_lens_dev(), self._dev_active,
        ).cpu().numpy()
        self.decode_steps += 1
        self.counters["decode_dispatches"] += 1
        self.counters["host_sample_rounds"] += 1
        self.counters["slot_steps"] += n_active
        self._m_occ.observe(float(n_active))
        self.occupancy_max = max(self.occupancy_max, n_active)
        now = time.time()
        decode_dt = now - t_dec0
        self._iter_device_s += decode_dt
        for slot, req in decoding:
            self.kv.note_written(slot, int(self.kv.seq_lens[slot]) + 1)
            tok = self._sample(req, logits[slot])
            self._charge_decode(req, now, decode_dt, spec=False)
            self._commit_tokens(slot, req, [tok], n_active, now)

    def _charge_decode(self, req: GenRequest, now: float,
                       decode_dt: float, spec: bool) -> None:
        """Advance the request's attribution frontier to ``now``: this
        iteration's decode wall to decode (or speculation), up to its
        prefill wall to interference stall, the rest to scheduler gap."""
        interval = max(now - req._t_attr, 0.0)
        d = min(interval, max(decode_dt, 0.0))
        if spec:
            req.attr_spec_s += d
        else:
            req.attr_decode_s += d
        s = min(interval - d, max(self._iter_prefill_s, 0.0))
        req.attr_stall_s += s
        req.attr_gap_s += interval - d - s
        req._t_attr = now

    def _commit_tokens(self, slot: int, req: GenRequest, kept: list[int],
                       n_active: int, now: float) -> None:
        """Per-request bookkeeping of this iteration's committed tokens,
        one implementation for the host and fused paths."""
        req.occ_sum += n_active
        req.occ_steps += 1
        req.occ_max = max(req.occ_max, n_active)
        req.tokens.extend(kept)
        self.usage.on_tokens(req, len(kept))
        self.counters["decode_tokens"] += len(kept)
        self._m_tok_step.observe(float(len(kept)))
        if req._t_last_token:
            req.itl_max_s = max(req.itl_max_s, now - req._t_last_token)
        req._t_last_token = now
        self._last_tokens[slot] = kept[-1]
        self._stream_emit(req, kept)
        self._maybe_finish(req)

    def _decode_step_fused(self, decoding, n_active: int) -> None:
        """One fused iteration: build the draft window (if any), run ONE
        program, commit the emitted bursts.  K/V is written for the whole
        window; the host commits ``committed + accepted`` positions, and
        an EOS inside a burst truncates the tokens and retreats the
        extent (``kv.rollback``)."""
        t_dec0 = time.time()
        drafts: dict[int, list[int]] = {}
        if self.speculate:
            for i, r in decoding:
                cap = min(self.speculate,
                          r.max_new_tokens - len(r.tokens) - 1)
                if cap > 0:
                    # min_ngram 2: a single repeated token is mostly
                    # coincidence, and a spurious draft pays the window
                    d = spec_draft.propose(
                        r.prompt + r.tokens, cap, max_ngram=self.spec_ngram,
                        min_ngram=min(2, self.spec_ngram))
                    if d:
                        drafts[i] = d
        # the program is chosen per batch: one drafting slot takes every
        # active slot through the T = K + 1 program this iteration
        t_width = self.speculate + 1 if drafts else 1
        for i, r in decoding:
            s = int(self.kv.seq_lens[i])
            self.kv.ensure_writable_range(
                i, s, s + 1 + len(drafts.get(i, ())))
        self._refresh_slot_meta()
        draft_lens = np.zeros((self.max_slots,), np.int64)
        if t_width > 1:
            toks = np.zeros((self.max_slots, t_width), np.int64)
            toks[:, 0] = self._last_tokens
            for i, d in drafts.items():
                toks[i, 1:1 + len(d)] = d
                draft_lens[i] = len(d)
            tokens_in = self._to_dev(toks)
            dev_draft_lens = self._to_dev(draft_lens)
            fn = self._fused_spec
        else:
            tokens_in = self._dev_tokens  # the device-resident feed
            dev_draft_lens = self._dev_zero_drafts
            fn = self._fused1
        packed, self._dev_tokens = fn(
            self.model, self.kv.k_pool, self.kv.v_pool, tokens_in,
            dev_draft_lens, self._tables_dev(), self._seq_lens_dev(),
            self._dev_active, self._dev_seeds, self._dev_prompt_lens,
            self._dev_temp, self._dev_topk, all_greedy=self._all_greedy)
        packed = packed.cpu().numpy()  # the one host read an iteration
        out = packed[:, :-1]
        n_emit = packed[:, -1]
        self.decode_steps += 1
        self.counters["decode_dispatches"] += 1
        self.counters["slot_steps"] += n_active
        self._m_occ.observe(float(n_active))
        self.occupancy_max = max(self.occupancy_max, n_active)
        now = time.time()
        decode_dt = now - t_dec0
        self._iter_device_s += decode_dt
        for slot, req in decoding:
            n = int(n_emit[slot])
            emitted = [int(t) for t in out[slot, :n]]
            k_drafted = int(draft_lens[slot])
            accepted = n - 1
            s = int(self.kv.seq_lens[slot])
            # commit the last input token's and every accepted draft's K/V
            self.kv.note_written(slot, s + 1 + accepted)
            kept = emitted
            if req.eos_token_id is not None and req.eos_token_id in emitted:
                kept = emitted[:emitted.index(req.eos_token_id) + 1]
                if len(kept) < n:
                    # tokens after the EOS never happened
                    self.kv.rollback(slot, s + len(kept))
            if k_drafted:
                # committed drafts only: one discarded after an EOS does
                # not count as accepted
                committed = accepted if len(kept) == n else len(kept)
                req.drafted += k_drafted
                req.accepted += committed
                self.counters["spec_drafted"] += k_drafted
                self.counters["spec_accepted"] += committed
                self._m_spec_drafted.inc(k_drafted)
                if committed:
                    self._m_spec_accepted.inc(committed)
            self._charge_decode(req, now, decode_dt, spec=t_width > 1)
            self._commit_tokens(slot, req, kept, n_active, now)

    def _sample(self, req: GenRequest, logits: np.ndarray) -> int:
        """The host sampler: greedy, or temperature/top-k from the shared
        fp32 reference math, deterministic per request seed."""
        if req.temperature <= 0.0:
            return int(np.argmax(logits))
        probs = sampling.logits_to_probs(
            logits, req.temperature, req.top_k
        ).astype(np.float64)  # np.random wants probs summing to 1 in f64
        return int(req._rng.choice(len(probs), p=probs / probs.sum()))

    def _stream_emit(self, req: GenRequest, toks: list[int]) -> None:
        """Push committed tokens to a streaming request's event queue."""
        if req._events is not None and toks:
            req._events.put(("tokens", list(toks)))

    def _maybe_finish(self, req: GenRequest) -> None:
        last = req.tokens[-1]
        if req.eos_token_id is not None and last == req.eos_token_id:
            self._finish(req, "eos")
        elif len(req.tokens) >= req.max_new_tokens:
            self._finish(req, "length")

    def _finish(self, req: GenRequest, reason: str | None,
                status: str = "ok") -> None:
        """Evict: release the slot's block references, close out the
        metrics and logs, signal the caller."""
        if req.slot is not None:
            self.kv.release(req.slot)
            self._slots[req.slot] = None
            self._slot_meta_dirty = True
            if self._prefill_cache_state is not None \
                    and self._prefill_cache_state[0] == req.slot:
                self._prefill_cache_state = None
        if req in self._filling:  # error paths only
            self._filling.remove(req)
        req.status = status
        req.finish_reason = reason if status == "ok" else None
        req.t_done = time.time()
        if req._t_attr:
            # the residue after the last commit is scheduler gap
            req.attr_gap_s += max(req.t_done - req._t_attr, 0.0)
            req._t_attr = req.t_done
        self._step_evicted += 1
        self.counters[status] += 1
        self._m_requests.inc(status=status)
        if status == "ok":
            self.counters["tokens_generated"] += len(req.tokens)
            self._m_tokens.inc(len(req.tokens))
            self._m_e2e.observe(req.e2e_s)
            self._m_tpot.observe(req.tpot_s)
            self._emit_trace_spans(req)
        self._m_active.set(sum(r is not None for r in self._slots))
        self._update_kv_metrics()
        self._log_request(req)
        self.usage.on_finish(req)
        if req._events is not None:
            req._events.put(("done", None))
        req._done.set()

    def _update_kv_metrics(self) -> None:
        """Mirror the pool's census into the registry (gauges set, the
        monotonic counters bridged as deltas)."""
        alloc = self.kv.allocator
        self._m_blocks_free.set(alloc.free_blocks)
        self._m_blocks_cached.set(alloc.cached_blocks)
        self._m_block_refs.set(alloc.total_refs)
        if alloc.evictions > self._last_evictions:
            self._m_evictions.inc(alloc.evictions - self._last_evictions)
            self._last_evictions = alloc.evictions
        if self.kv.cow_copies > self._last_cow:
            self._m_cow.inc(self.kv.cow_copies - self._last_cow)
            self._last_cow = self.kv.cow_copies
        stats = self.kv.stats()
        self._m_frag.set(stats["fragmentation"])
        self._m_prefix_occ.set(stats["prefix_occupancy"])
        self._m_prefix_rate.set(stats["prefix_hit_rate"])

    def _emit_trace_spans(self, req: GenRequest) -> None:
        """A root span per completed request plus its queue, prefill and
        decode phases, under the request's trace_id, from the lifecycle
        stamps; a no-op when no recorder is installed."""
        if obs_tracing.active_recorder() is None:
            return
        root = obs_tracing.new_span_id()
        obs_tracing.record_remote_span(
            "serve.request", t0=req.t_submit, dur_s=req.e2e_s,
            trace_id=req.trace_id, span_id=root, request=req.id,
            prompt_tokens=len(req.prompt), new_tokens=len(req.tokens),
            cached_prefix_tokens=req.cached_prefix_tokens)
        obs_tracing.record_remote_span(
            "serve.queue", t0=req.t_submit,
            dur_s=max(req.t_admit - req.t_submit, 0.0),
            trace_id=req.trace_id, parent_id=root, request=req.id)
        obs_tracing.record_remote_span(
            "serve.prefill", t0=req.t_admit,
            dur_s=max(req.t_first_token - req.t_admit, 0.0),
            trace_id=req.trace_id, parent_id=root, request=req.id,
            slot=req.slot if req.slot is not None else -1)
        if len(req.tokens) > 1:
            obs_tracing.record_remote_span(
                "serve.decode", t0=req.t_first_token,
                dur_s=max(req.t_done - req.t_first_token, 0.0),
                trace_id=req.trace_id, parent_id=root, request=req.id,
                tokens=len(req.tokens))

    # -- loop / lifecycle ----------------------------------------------------

    def start(self) -> "Engine":
        if self._stopped or self._crashed is not None:
            raise RuntimeError("engine cannot be restarted after stop()")
        if self._thread is None:
            self._stop_flag = False
            self._thread = threading.Thread(
                target=self._run, name="dtf-torch-serve-engine", daemon=True)
            self._thread.start()
        return self

    @property
    def healthy(self) -> bool:
        """False once the loop has died or been stopped (``/healthz``
        answers 503)."""
        return self._crashed is None and not self._stopped

    def _run(self) -> None:
        while True:
            try:
                did = self.step()
            except Exception as e:  # noqa: BLE001 - fail every in-flight req
                self._crashed = repr(e)
                self._fail_all(f"engine loop error: {e!r}")
                raise
            with self._cond:
                if self._stop_flag:
                    return
                if not did and not self._queue:
                    self._cond.wait(timeout=0.05)

    def stop(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop the loop.  ``drain=True`` finishes in-flight and queued
        requests first; ``drain=False`` errors them out.  Then the logs
        close, the usage ledger writes its final row and ``metrics.prom``
        its last snapshot."""
        if self._thread is not None:
            if drain:
                deadline = time.time() + timeout
                while time.time() < deadline:
                    with self._cond:
                        idle = not self._queue and all(
                            r is None for r in self._slots)
                    if idle or self._crashed is not None:
                        break
                    time.sleep(0.01)
            with self._cond:
                self._stop_flag = True
                self._cond.notify_all()
            self._thread.join(timeout=timeout)
            self._thread = None
        self._stopped = True
        self._fail_all("engine stopped")
        self._log_metrics_row()
        with self._log_lock:
            for name in ("_req_log", "_met_log", "_step_log"):
                f = getattr(self, name)
                if f is not None:
                    f.close()
                    setattr(self, name, None)
        self.usage.close()
        if self.logdir:
            self._registry.write_prometheus(
                os.path.join(self.logdir, "metrics.prom"))

    def __enter__(self) -> "Engine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _fail_all(self, message: str) -> None:
        with self._cond:
            doomed = list(self._queue)
            self._queue.clear()
            self._m_queue.set(0)
        self._filling.clear()  # entries are also in _slots, failed below
        doomed += [r for r in self._slots if r is not None]
        for req in doomed:
            req.error = message
            self._finish(req, None, status="error")

    # -- introspection / logs ------------------------------------------------

    def state(self) -> dict:
        """JSON-safe engine state (``GET /generatez``)."""
        with self._lock:
            queue_depth = len(self._queue)
        slots = [
            None if r is None else {
                "id": r.id, "tenant": r.tenant,
                "seq_len": int(self.kv.seq_lens[i]),
                "new_tokens": len(r.tokens),
                "max_new_tokens": r.max_new_tokens,
                "phase": "decode" if r._prefill_done else "prefill",
                "cached_prefix_tokens": r.cached_prefix_tokens,
            }
            for i, r in enumerate(self._slots)
        ]
        c = self.counters
        return {
            "queue_depth": queue_depth,
            "max_queue": self.max_queue,
            "max_slots": self.max_slots,
            "active_slots": sum(s is not None for s in slots),
            "filling_slots": sum(
                s is not None and s["phase"] == "prefill" for s in slots),
            "slots": slots,
            "decode_steps": self.decode_steps,
            "occupancy_max": self.occupancy_max,
            "prefill_iters": self.prefill_iters,
            "prefill_chunks": self.prefill_chunks,
            "prefill_budget_stalls": self.prefill_budget_stalls,
            "steps_total": self._step_id,
            "step_ring_size": self.step_ring_size,
            "kv": self.kv.stats(),
            "counters": dict(c),
            "prefill_chunk": self.prefill_chunk,
            "prefill_budget": self.prefill_budget or 0,
            "prefix_cache": self.prefix_cache,
            "fused_sampling": self.fused_sampling,
            "speculate": self.speculate,
            "spec_acceptance_rate": (
                c["spec_accepted"] / c["spec_drafted"]
                if c["spec_drafted"] else 0.0),
            "tokens_per_step": (c["decode_tokens"] / c["slot_steps"]
                                if c["slot_steps"] else 0.0),
            "max_context": self.kv.max_context,
        }

    def _log_request(self, req: GenRequest) -> None:
        row = {
            "id": req.id,
            "status": req.status,
            "prompt_tokens": len(req.prompt),
            "new_tokens": len(req.tokens),
            "trace_id": req.trace_id,
            "tenant": req.tenant,
        }
        if req.status == "ok":
            queue_s = round(max(req.t_admit - req.t_submit, 0.0), 6)
            row.update(
                finish_reason=req.finish_reason,
                ttft_s=round(req.ttft_s, 6),
                tpot_s=round(req.tpot_s, 6),
                e2e_s=round(req.e2e_s, 6),
                queue_s=queue_s,
                slot=req.slot if req.slot is not None else -1,
                occ_mean=(round(req.occ_sum / req.occ_steps, 3)
                          if req.occ_steps else 0.0),
                occ_max=req.occ_max,
                cached_prefix_tokens=req.cached_prefix_tokens,
                prefill_tokens=req.prefill_tokens,
                itl_max_s=round(req.itl_max_s, 6),
                drafted=req.drafted,
                accepted=req.accepted,
                spec_drafted=req.drafted,
                spec_accepted=req.accepted,
                # queue + prefill + stall + decode + spec + gap == e2e
                attr_queue_s=queue_s,
                attr_prefill_s=round(req.attr_prefill_s, 6),
                attr_stall_s=round(req.attr_stall_s, 6),
                attr_decode_s=round(req.attr_decode_s, 6),
                attr_spec_s=round(req.attr_spec_s, 6),
                attr_gap_s=round(req.attr_gap_s, 6),
            )
        elif req.error:
            row["error"] = req.error
        with self._log_lock:
            # stamped under the lock: the stream stays time-ordered
            # across the engine and HTTP threads
            if self._req_log is None:
                return
            row = {"t": time.time(), **row}
            self._req_log.write(json.dumps(json_sanitize(row)) + "\n")
            self._req_log.flush()

    def _log_metrics_row(self) -> None:
        kv = self.kv.stats()
        c = self.counters
        row = {
            "step": self.decode_steps,
            "queue_depth": len(self._queue),
            "active_slots": sum(r is not None for r in self._slots),
            "filling_slots": len(self._filling),
            "occupancy_max": self.occupancy_max,
            "blocks_free": kv["blocks_free"],
            "blocks_cached": kv["blocks_cached"],
            "block_refs": kv["block_refs"],
            "kv_fragmentation": round(kv["fragmentation"], 4),
            "prefix_occupancy": round(kv["prefix_occupancy"], 4),
            "prefix_hit_rate": round(kv["prefix_hit_rate"], 4),
            "prefix_lookups_total": kv["prefix_lookups"],
            "prefix_hits_total": kv["prefix_hits"],
            "prefix_cached_tokens_total": kv["prefix_cached_tokens"],
            "prefill_tokens_total": c["prefill_tokens"],
            "prefix_evictions_total": kv["prefix_evictions"],
            "cow_copies_total": kv["cow_copies"],
            "prefill_iters": self.prefill_iters,
            "prefill_chunks": self.prefill_chunks,
            "prefill_chunk": self.prefill_chunk,
            "prefill_budget": self.prefill_budget or 0,
            "requests_ok_total": c["ok"],
            "requests_rejected_total": c["rejected"],
            "requests_error_total": c["error"],
            "tokens_generated_total": c["tokens_generated"],
            "fused_sampling": int(self.fused_sampling),
            "speculate": self.speculate,
            "spec_drafted_total": c["spec_drafted"],
            "spec_accepted_total": c["spec_accepted"],
            "spec_acceptance_rate": round(
                c["spec_accepted"] / c["spec_drafted"], 4
            ) if c["spec_drafted"] else 0.0,
            "decode_tokens_total": c["decode_tokens"],
            # per slot: 1.0 without speculation, up to speculate + 1
            "tokens_per_step": round(
                c["decode_tokens"] / c["slot_steps"], 4
            ) if c["slot_steps"] else 0.0,
            "decode_dispatches_total": c["decode_dispatches"],
            "host_sample_rounds_total": c["host_sample_rounds"],
        }
        with self._log_lock:
            if self._met_log is None:
                return
            self._met_log.write(json.dumps(json_sanitize(row)) + "\n")
            self._met_log.flush()
        if self.logdir:
            self._registry.write_prometheus(
                os.path.join(self.logdir, "metrics.prom"))
