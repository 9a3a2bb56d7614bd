"""Continuous-batching generation engine: queue -> slots -> paged decode.

Twin of ``distributedtensorflow_tpu/serve/engine.py`` at its defaults
(no prefix cache, host sampling, no speculation, unbudgeted prefill):

- a bounded, thread-safe FIFO queue; a full queue rejects with
  :class:`QueueFullError`;
- every scheduler iteration admits queued requests into free slots,
  strictly in arrival order, and only when a slot AND the request's
  whole worst-case block reservation are free (no mid-flight OOM);
- then runs the admitted requests' prefill chunks, samples each one's
  first token when its last chunk completes, and runs ONE paged decode
  step for every slot whose prefill is done;
- finished requests (eos or ``max_new_tokens``) release their blocks at
  once, and a freed slot takes the next queued request while the others
  keep decoding.

Sampling is on the host from the decode step's logits: greedy, or
temperature/top-k through :func:`serve.sampling.logits_to_probs` and the
request's own ``np.random.default_rng(seed)``.

Threading: callers on any thread only touch :meth:`Engine.submit`
(queue and lock); the device work and all ``PagedKVCache`` changes
happen on the single loop thread (:meth:`Engine.start`), or on the
caller's thread when tests drive :meth:`Engine.step` directly.
Observability, tracing, usage metering, log streams, the prefix cache,
fused sampling, speculation and the prefill budget are not ported yet.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import math
import threading
import time

import numpy as np
import torch

from ..models.gpt import GPTLM
from . import sampling
from .kv_cache import PagedKVCache
from .model import (
    make_decode_fn,
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
    # -- chunked-prefill state (engine thread only) --
    _fill_buf: np.ndarray | None = dataclasses.field(default=None,
                                                     repr=False)
    _fill_next: int = 0               # next chunk's first absolute position
    _fill_pad: int = 0                # padded prefill extent
    _prefill_done: bool = False
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
        prefill_chunk: int = 16,
        max_context: int | None = None,
        max_new_cap: int | None = None,
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
        self.model = model
        self.device = model.device
        self.cfg = dataclasses.replace(cfg, max_seq=max_context)
        self.max_slots = max_slots
        self.max_queue = max_queue
        self.max_new_cap = max_new_cap
        self.prefill_chunk = prefill_chunk
        # full provisioning: every slot can hold max_context
        self.kv = PagedKVCache(
            num_layers=cfg.num_layers, kv_heads=cfg.kv_heads,
            head_dim=cfg.head_dim, max_slots=max_slots,
            num_blocks=max_slots * (max_context // block_size),
            block_size=block_size, max_context=max_context, dtype=cfg.dtype,
            device=self.device,
        )
        self._prefill = make_prefill_fn(self.cfg, chunk=prefill_chunk,
                                        block_size=block_size)
        self._decode = make_decode_fn(self.cfg)
        self._gather = make_gather_cache_fn(self.cfg, block_size=block_size)
        self._prefill_cache = model.init_cache(1, max_context)
        #: (slot, pos): the dense prefill cache holds that slot's K/V for
        #: positions [0, pos), so its next chunk skips the pool gather.
        self._prefill_cache_state: tuple[int, int] | None = None
        # device copies of the page tables and the active mask, re-sent
        # only when they change
        self._dev_tables = None
        self._dev_tables_version = -1
        self._active_dirty = True
        self._dev_active = None

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: collections.deque[GenRequest] = collections.deque()
        self._ids = itertools.count()
        self._slots: list[GenRequest | None] = [None] * max_slots
        self._slot_reused = [False] * max_slots
        #: admitted requests whose prefill has not finished, in order
        self._filling: collections.deque[GenRequest] = collections.deque()
        self._last_tokens = np.zeros((max_slots,), np.int64)
        self._thread: threading.Thread | None = None
        self._stop_flag = False
        self._crashed: str | None = None
        self._stopped = False
        self.decode_steps = 0
        self.occupancy_max = 0
        self.prefill_chunks = 0
        self.counters = {
            "submitted": 0, "ok": 0, "rejected": 0, "error": 0,
            "tokens_generated": 0, "admits": 0, "admits_into_freed_slot": 0,
        }

    # -- submission (any thread) ---------------------------------------------

    def submit(self, prompt, *, max_new_tokens: int, temperature: float = 0.0,
               top_k: int = 0, eos_token_id: int | None = None,
               seed: int = 0) -> GenRequest:
        """Validate and enqueue; returns the live :class:`GenRequest`.
        Raises ``ValueError`` on a malformed request,
        :class:`QueueFullError` when the queue is full and
        ``RuntimeError`` once the engine is stopped or its loop died."""
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
        footprint = self._footprint(len(prompt), max_new_tokens)
        if footprint > self.kv.max_context:
            raise ValueError(
                f"request footprint {footprint} tokens (prompt "
                f"{len(prompt)} padded to the {self.prefill_chunk}-token "
                f"prefill chunk, + {max_new_tokens} new) exceeds "
                f"max_context={self.kv.max_context}")
        req = GenRequest(
            id=f"r{next(self._ids)}", prompt=prompt,
            max_new_tokens=int(max_new_tokens), temperature=temperature,
            top_k=top_k, eos_token_id=eos_token_id, seed=int(seed),
            t_submit=time.time(),
        )
        req._rng = np.random.default_rng(req.seed)
        with self._cond:
            if self._stopped or self._stop_flag or self._crashed is not None:
                raise RuntimeError("engine stopped")
            if len(self._queue) >= self.max_queue:
                req.status = "rejected"
                req.t_done = time.time()
                req._done.set()
                self.counters["rejected"] += 1
                raise QueueFullError(
                    f"queue full ({self.max_queue} requests waiting)")
            self.counters["submitted"] += 1
            self._queue.append(req)
            self._cond.notify()
        return req

    def generate(self, prompt, *, timeout: float | None = None,
                 **kwargs) -> GenRequest:
        """Blocking convenience: submit and wait (needs :meth:`start`)."""
        req = self.submit(prompt, **kwargs)
        if not req.wait(timeout):
            raise TimeoutError(f"request {req.id} still running")
        return req

    # -- scheduler (engine thread) -------------------------------------------

    def _padded_prompt_len(self, prompt_len: int) -> int:
        """Prompt length rounded up to whole prefill chunks: the extent
        the prefill program writes K/V through, pad positions included."""
        c = self.prefill_chunk
        return -(-prompt_len // c) * c

    def _footprint(self, prompt_len: int, max_new: int) -> int:
        """Worst-case KV positions a request can touch."""
        return max(self._padded_prompt_len(prompt_len), prompt_len + max_new)

    def _tables_dev(self) -> torch.Tensor:
        if self._dev_tables_version != self.kv.tables_version:
            self._dev_tables = torch.from_numpy(
                self.kv.block_tables.astype(np.int64)).to(self.device)
            self._dev_tables_version = self.kv.tables_version
        return self._dev_tables

    def _active_dev(self) -> torch.Tensor:
        if self._active_dirty:
            active = np.array([r is not None and r._prefill_done
                               for r in self._slots])
            self._dev_active = torch.from_numpy(active).to(self.device)
            self._active_dirty = False
        return self._dev_active

    @torch.no_grad()
    def step(self) -> bool:
        """One scheduler iteration: admit -> prefill -> decode -> evict.
        Returns True when any work happened."""
        admitted = self._admit_from_queue()
        chunks = self._run_prefill()
        occupancy = sum(r is not None and r._prefill_done
                        for r in self._slots)
        if occupancy:
            self._run_decode_step()
        return bool(admitted or chunks or occupancy)

    def _admit_from_queue(self) -> list[GenRequest]:
        """Strict FIFO: pop the head only while a slot AND its whole block
        reservation fit (head-of-line blocking keeps fairness)."""
        admitted = []
        with self._cond:
            while self._queue:
                free = [i for i, r in enumerate(self._slots) if r is None]
                if not free:
                    break
                head = self._queue[0]
                slot = free[0]
                pages = self.kv.admit(
                    slot, self._footprint(len(head.prompt),
                                          head.max_new_tokens))
                if pages is None:  # pool pressure
                    break
                self._queue.popleft()
                head.slot = slot
                head.status = "active"
                head.t_admit = time.time()
                head._fill_buf = np.zeros(
                    (self._padded_prompt_len(len(head.prompt)),), np.int64)
                head._fill_buf[:len(head.prompt)] = head.prompt
                head._fill_pad = len(head._fill_buf)
                head._fill_next = 0
                self._slots[slot] = head
                self._active_dirty = True
                if self._prefill_cache_state is not None \
                        and self._prefill_cache_state[0] == slot:
                    # never alias the previous tenant's dense cache
                    self._prefill_cache_state = None
                self._filling.append(head)
                if self._slot_reused[slot]:
                    self.counters["admits_into_freed_slot"] += 1
                self._slot_reused[slot] = True
                self.counters["admits"] += 1
                admitted.append(head)
        return admitted

    def _run_prefill(self) -> int:
        """Every admitted request's remaining prefill chunks, in order;
        each request samples its first token when its last chunk is done.
        Returns the chunk count."""
        chunks = 0
        while self._filling:
            req = self._filling.popleft()
            while True:
                last_logits = self._run_prefill_chunk(req)
                chunks += 1
                if req._fill_next >= req._fill_pad:
                    break
            self._finish_prefill(req, last_logits)
        self.prefill_chunks += chunks
        return chunks

    def _run_prefill_chunk(self, req: GenRequest) -> torch.Tensor:
        """One fixed-width chunk of one request.  The dense prefill cache
        is rebuilt from the slot's pool blocks unless it already holds
        exactly this slot's K/V up to the chunk start."""
        slot = req.slot
        c = self.prefill_chunk
        start = req._fill_next
        table_row = self.kv.block_tables[slot]
        if self._prefill_cache_state != (slot, start):
            if start:
                self._gather(self.kv.k_pool, self.kv.v_pool,
                             self._prefill_cache, table_row, start)
            else:
                reset_cache_index(self._prefill_cache)
        last_ix = min(max(len(req.prompt) - 1 - start, 0), c - 1)
        tokens = torch.from_numpy(req._fill_buf[None, start:start + c]).to(
            self.device)
        last_logits = self._prefill(
            self.model, self.kv.k_pool, self.kv.v_pool, self._prefill_cache,
            tokens, start, table_row, last_ix)
        req._fill_next = start + c
        self._prefill_cache_state = (slot, start + c)
        self.kv.note_written(
            slot, max(min(start + c, len(req.prompt)),
                      int(self.kv.seq_lens[slot])))
        return last_logits

    def _finish_prefill(self, req: GenRequest, last_logits) -> None:
        """Sample the first token (TTFT stops here) and hand the slot to
        the decode batch."""
        req._prefill_done = True
        self._active_dirty = True
        tok = self._sample(req, last_logits.cpu().numpy())
        req.t_first_token = time.time()
        req.tokens.append(tok)
        self._last_tokens[req.slot] = tok
        self._maybe_finish(req)

    def _run_decode_step(self) -> None:
        """One paged decode step for every slot whose prefill is done,
        then host sampling of one token each."""
        decoding = [(i, r) for i, r in enumerate(self._slots)
                    if r is not None and r._prefill_done]
        n_active = len(decoding)
        logits = self._decode(
            self.model, self.kv.k_pool, self.kv.v_pool,
            torch.from_numpy(self._last_tokens).to(self.device),
            self._tables_dev(),
            torch.from_numpy(self.kv.seq_lens.astype(np.int64)).to(
                self.device),
            self._active_dev(),
        ).cpu().numpy()
        self.decode_steps += 1
        self.occupancy_max = max(self.occupancy_max, n_active)
        for slot, req in decoding:
            self.kv.note_written(slot, int(self.kv.seq_lens[slot]) + 1)
            tok = self._sample(req, logits[slot])
            req.tokens.append(tok)
            self._last_tokens[slot] = tok
            self._maybe_finish(req)

    def _sample(self, req: GenRequest, logits: np.ndarray) -> int:
        """Greedy, or temperature/top-k from the shared fp32 reference
        math, deterministic per request seed."""
        if req.temperature <= 0.0:
            return int(np.argmax(logits))
        probs = sampling.logits_to_probs(
            logits, req.temperature, req.top_k
        ).astype(np.float64)  # np.random wants probs summing to 1 in f64
        return int(req._rng.choice(len(probs), p=probs / probs.sum()))

    def _maybe_finish(self, req: GenRequest) -> None:
        last = req.tokens[-1]
        if req.eos_token_id is not None and last == req.eos_token_id:
            self._finish(req, "eos")
        elif len(req.tokens) >= req.max_new_tokens:
            self._finish(req, "length")

    def _finish(self, req: GenRequest, reason: str | None,
                status: str = "ok") -> None:
        """Evict: release the slot's blocks and signal the caller."""
        if req.slot is not None:
            self.kv.release(req.slot)
            self._slots[req.slot] = None
            self._active_dirty = True
            if self._prefill_cache_state is not None \
                    and self._prefill_cache_state[0] == req.slot:
                self._prefill_cache_state = None
        if req in self._filling:  # error paths only
            self._filling.remove(req)
        req.status = status
        req.finish_reason = reason if status == "ok" else None
        req.t_done = time.time()
        self.counters[status] += 1
        if status == "ok":
            self.counters["tokens_generated"] += len(req.tokens)
        req._done.set()

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
        requests first; ``drain=False`` errors them out."""
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

    def __enter__(self) -> "Engine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _fail_all(self, message: str) -> None:
        with self._cond:
            doomed = list(self._queue)
            self._queue.clear()
        self._filling.clear()  # entries are also in _slots, failed below
        doomed += [r for r in self._slots if r is not None]
        for req in doomed:
            req.error = message
            self._finish(req, None, status="error")
