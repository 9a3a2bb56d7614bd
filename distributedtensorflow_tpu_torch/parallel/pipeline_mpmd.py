"""MPMD pipeline parallelism: each stage is a separate program.

Twin of ``distributedtensorflow_tpu/parallel/pipeline_mpmd.py``, the
design of "Scaling Deep Learning Training with MPMD Pipeline
Parallelism" (arxiv 2412.14374): each pipeline stage is its own OS
process with its own parameters, its own step and its own Adam, run as a
process worker of :class:`.coordinator.Coordinator`, so a stage's death
rides the coordinator's retry and respawn instead of killing the run.
The SPMD schedules of ``parallel.pipeline`` run every stage as a rank of
one process group; here no collective spans the stages.

Wire contract (the ``data/wire.py`` raw tensor frames, byte for byte the
JAX package's, so a link may join a stage of either package):

- stage ``i`` holds one persistent loopback TCP link to stage ``i+1``
  (``u64 LE frame length | DTW1 frame``); activations flow down the
  link and cotangents back up the same link;
- every frame is a raw tensor dict (optional CRC32C) whose header echoes
  the sender's trace context, so the receiver's ``pipeline.handoff``
  span parents under the sender's step span and ``tools/timeline.py
  --fleet`` stitches the stages' ``trace.jsonl`` files into one trace;
- the sender keeps at most ``window`` microbatches in flight a link
  (activation sent, cotangent not yet back): the credit window that
  bounds a stage's live activations;
- each link runs a reader and a writer thread, so a stage's compute
  overlaps the transfer.

Training: a GPT split layer-wise (the port's ``models.gpt.GPTBlock``).
Stage 0 holds the embedding and the first blocks; the last stage holds
the last blocks, ``ln_f`` and an untied head without bias (a tied head
would need a cross-stage exchange for the shared table: the coupling
MPMD removes).  fp32, no block remat.  The backward saves the stage's
input and recomputes its forward under autograd when the cotangent comes
back (``torch.autograd.grad`` for the parameters, and for the input too
on a middle stage), where JAX takes ``jax.vjp`` of the stage's apply.
Gradients are stage-local, so each stage applies its own Adam
(``train.optimizers.adamw`` without decay: ``optax.adam``) with no
cross-stage collective.  :attr:`MPMDConfig.device` (``cuda`` by default;
``device.resolve_device``) is where a stage computes; JAX's stages run on
their process's default device.  On the card every block runs the
LayerNorm kernels K1f/K1b and, at the flash gate's sequence lengths, the
flash kernels K2/K3f (``ops.flash_attention``); ``ln_f`` runs K1f/K1b,
and the head's product and log-softmax are ``torch`` calls, as JAX's
``nn.Dense`` runs outside any Pallas kernel.

Failure contract: a killed stage severs its links; every peer's closure
raises :class:`.coordinator.WorkerUnavailableError`, the coordinator
re-queues every stage closure, the killed process respawns (budget and
backoff), and the run re-executes deterministically from its seeds.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import queue
import socket
import struct
import threading
import time
from typing import Any

import numpy as np
import torch

from .. import obs
from ..data import wire
from ..obs.tracing import (
    TraceRecorder,
    current_context,
    new_trace_id,
    record_remote_span,
    remote_span,
)
from .coordinator import Coordinator, WorkerUnavailableError
from .pipeline import fb_schedule

_LEN = struct.Struct("<Q")

_H_HANDOFF = obs.histogram(
    "pipeline_handoff_seconds",
    "MPMD stage handoff latency: sender's frame stamp to receiver decode, "
    "labeled by the RECEIVING stage",
)
_H_STALL = obs.histogram(
    "pipeline_mpmd_stall_seconds",
    "seconds a stage spent blocked on its credit window (activations in "
    "flight == window) before the next cotangent freed a slot, by stage",
)


@dataclasses.dataclass(frozen=True)
class MPMDConfig:
    """Model and schedule of one MPMD pipeline run (picklable: it rides
    the coordinator's closure pipe into every stage process)."""

    n_stages: int = 2
    n_steps: int = 8
    n_microbatches: int = 4
    microbatch_size: int = 4
    seq_len: int = 32
    vocab_size: int = 256
    hidden_size: int = 64
    num_layers: int = 2
    num_heads: int = 4
    #: credit window: activation microbatches in flight a link before the
    #: sender blocks (a stage's live-activation bound)
    window: int = 2
    lr: float = 1e-2
    seed: int = 0
    crc: bool = True
    recv_timeout_s: float = 120.0
    connect_timeout_s: float = 60.0
    #: where each stage computes ("cuda" unless the caller asks for "cpu")
    device: str = "cuda"

    def validate(self) -> None:
        if self.n_stages < 2:
            raise ValueError("MPMD pipeline needs n_stages >= 2")
        if self.num_layers % self.n_stages:
            raise ValueError(
                f"num_layers={self.num_layers} not divisible by "
                f"n_stages={self.n_stages}")
        if self.window < 1:
            raise ValueError("window must be >= 1")
        if self.hidden_size % self.num_heads:
            raise ValueError("hidden_size must divide into num_heads")


# --- framed link over one TCP socket -----------------------------------


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed the link")
        buf += chunk
    return bytes(buf)


class _Link:
    """One persistent stage-to-stage connection: a reader and a writer
    thread (compute and transfer overlap), framed raw-tensor payloads."""

    def __init__(self, sock: socket.socket, name: str, crc: bool):
        self._sock = sock
        self._name = name
        self._crc = crc
        self.rx: queue.Queue = queue.Queue()
        self._tx: queue.Queue = queue.Queue()
        self._dead: BaseException | None = None
        self._reader = threading.Thread(target=self._read_loop,
                                        name=f"{name}-rx", daemon=True)
        self._writer = threading.Thread(target=self._write_loop,
                                        name=f"{name}-tx", daemon=True)
        self._reader.start()
        self._writer.start()

    def _read_loop(self) -> None:
        try:
            while True:
                (ln,) = _LEN.unpack(_recv_exact(self._sock, _LEN.size))
                if ln > (1 << 31):
                    # The frame's CRC covers the payload, not this prefix:
                    # a desynced length fails the link at once instead of
                    # allocating towards 2^64 bytes.
                    raise ConnectionError(f"oversized frame ({ln} bytes)")
                payload = _recv_exact(self._sock, ln)
                trace = wire.peek_trace(payload)
                self.rx.put(("frame", wire.decode_tensors(payload), trace))
        except BaseException as e:  # noqa: BLE001 — surfaced to the loop
            self._dead = e
            self.rx.put(("dead", e, None))

    def _write_loop(self) -> None:
        try:
            while True:
                payload = self._tx.get()
                if payload is None:
                    return
                self._sock.sendall(_LEN.pack(len(payload)) + payload)
        except BaseException as e:  # noqa: BLE001
            self._dead = e
            self.rx.put(("dead", e, None))

    def send(self, tensors: dict, trace: dict | None = None) -> None:
        if self._dead is not None:
            raise WorkerUnavailableError(
                f"link {self._name} is dead: {self._dead!r}")
        self._tx.put(wire.encode_tensors(tensors, crc=self._crc, trace=trace))

    def poll(self, timeout: float) -> tuple[dict, dict | None] | None:
        """One frame, or None when nothing arrives within ``timeout``
        (raises on a severed link)."""
        try:
            if timeout > 0:
                kind, a, b = self.rx.get(timeout=timeout)
            else:
                kind, a, b = self.rx.get_nowait()
        except queue.Empty:
            return None
        if kind == "dead":
            raise WorkerUnavailableError(f"link {self._name} severed: {a!r}")
        return a, b

    def recv(self, timeout: float) -> tuple[dict, dict | None]:
        got = self.poll(timeout)
        if got is None:
            raise WorkerUnavailableError(
                f"link {self._name}: no frame within {timeout:.0f}s "
                "(stalled or dead peer)")
        return got

    def close(self) -> None:
        self._tx.put(None)
        # Drain the writer before severing the socket: a finishing
        # stage's last cotangent may still be queued, and the peer is
        # owed that frame.
        self._writer.join(timeout=10.0)
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


# --- loopback rendezvous -------------------------------------------------


def _port_file(rdir: str, link: int) -> str:
    return os.path.join(rdir, f"link{link}.port")


def _serve_link(rdir: str, link: int, timeout_s: float) -> socket.socket:
    """Bind an ephemeral loopback listener, publish its port (an atomic
    rename: a respawned server publishes a fresh port and the client's
    retry loop re-reads it), accept exactly one peer."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    os.makedirs(rdir, exist_ok=True)
    tmp = _port_file(rdir, link) + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(str(port))
    os.replace(tmp, _port_file(rdir, link))
    srv.settimeout(timeout_s)
    try:
        conn, _ = srv.accept()
    except socket.timeout:
        raise WorkerUnavailableError(
            f"link {link}: no upstream connection within {timeout_s:.0f}s"
        ) from None
    finally:
        srv.close()
    conn.settimeout(None)  # idleness is policed at the queue level
    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return conn


def _connect_link(rdir: str, link: int, timeout_s: float) -> socket.socket:
    """Dial the downstream peer's published port through
    ``net.rpc.connect_with_retry`` (backoff with jitter, the per-link
    attempt and retry metrics, a breaker); each attempt re-reads the
    port file, so a respawned server's fresh port is picked up."""
    from ..net import rpc as netrpc  # noqa: PLC0415

    path = _port_file(rdir, link)

    def _dial() -> socket.socket:
        with open(path) as f:
            port = int(f.read().strip())
        sock = socket.create_connection(("127.0.0.1", port), timeout=2.0)
        sock.settimeout(None)  # a connect timeout only; reads block
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    try:
        return netrpc.connect_with_retry(
            _dial, endpoint=f"mpmd_link:{link}", deadline_s=timeout_s,
            policy=netrpc.RetryPolicy(deadline_s=timeout_s,
                                      backoff_base_s=0.05,
                                      backoff_max_s=0.5),
            retryable=(OSError, ValueError))
    except (netrpc.DeadlineExceeded, ConnectionError) as e:
        raise WorkerUnavailableError(
            f"link {link}: could not connect within {timeout_s:.0f}s ({e})"
        ) from e


# --- the stage model -----------------------------------------------------


class StageModel(torch.nn.Module):
    """One stage's layers (JAX's ``Stage`` module): ``wte`` on stage 0,
    the stage's ``num_layers / n_stages`` blocks ``h.<i>``, and on the
    last stage ``ln_f`` (fp32 out) and the untied ``head`` (V, E) without
    bias; stage 0 takes token ids, the others the previous stage's
    hidden states, and the last returns fp32 logits."""

    def __init__(self, cfg: MPMDConfig, stage_id: int, device=None):
        super().__init__()
        from ..models.gpt import GPTBlock, GPTConfig
        from ..models.layers import FusedLayerNorm

        self.gcfg = GPTConfig(
            vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
            num_layers=cfg.num_layers // cfg.n_stages,
            num_heads=cfg.num_heads, intermediate_size=4 * cfg.hidden_size,
            max_seq=cfg.seq_len, dtype=torch.float32, remat=False)
        self.first = stage_id == 0
        self.last = stage_id == cfg.n_stages - 1
        e, v = cfg.hidden_size, cfg.vocab_size
        if self.first:
            self.wte = torch.nn.Embedding(v, e, device=device,
                                          dtype=torch.float32)
        self.h = torch.nn.ModuleList(
            [GPTBlock(self.gcfg, device=device)
             for _ in range(self.gcfg.num_layers)])
        if self.last:
            self.ln_f = FusedLayerNorm(e, out_dtype=torch.float32,
                                       device=device)
            self.head = torch.nn.Linear(e, v, bias=False, device=device,
                                        dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from ..models.gpt import rope_tables

        if self.first:
            x = self.wte.weight[x]
        positions = torch.arange(x.shape[1], device=x.device).expand(
            x.shape[:2])
        tabs = rope_tables(positions, self.gcfg.head_dim,
                           self.gcfg.rope_theta, torch.float32)
        for block in self.h:
            x = block(x, positions, tabs, None)
        if self.last:
            x = self.head(self.ln_f(x))
        return x


def stage_shapes(cfg: MPMDConfig, stage_id: int) -> dict[str, tuple]:
    """Parameter name -> shape of stage ``stage_id``'s state, in the
    state's order (the ``nn.Linear`` layouts, (out, in)).  Written out,
    not read off a model on the meta device: a module's initialiser on
    meta tensors goes through ``torch._refs``, whose first call imports
    ``torch._dynamo`` (seconds in a fresh stage process)."""
    e, v, f = cfg.hidden_size, cfg.vocab_size, 4 * cfg.hidden_size
    shapes = {"wte.weight": (v, e)} if stage_id == 0 else {}
    for i in range(cfg.num_layers // cfg.n_stages):
        shapes.update({f"h.{i}.{k}": shape for k, shape in (
            ("ln1.scale", (e,)), ("ln1.bias", (e,)),
            ("attn.qkv.weight", (3 * e, e)), ("attn.proj.weight", (e, e)),
            ("ln2.scale", (e,)), ("ln2.bias", (e,)),
            ("fc_in.weight", (f, e)), ("fc_out.weight", (e, f)))})
    if stage_id == cfg.n_stages - 1:
        shapes.update({"ln_f.scale": (e,), "ln_f.bias": (e,),
                       "head.weight": (v, e)})
    return shapes


def init_stage_state(cfg: MPMDConfig, stage_id: int) -> dict:
    """Stage ``stage_id``'s seeded initial state on the CPU: a
    ``torch.Generator`` seeded ``seed * 7919 + stage_id`` (JAX's
    ``PRNGKey``) draws, in the state's order, the embedding and the
    weights from normals at std 1/sqrt(input width) (as
    ``models.convert.init_params``); LayerNorm scales 1 and biases 0."""
    gen = torch.Generator().manual_seed(cfg.seed * 7919 + stage_id)
    state = {}
    for name, shape in stage_shapes(cfg, stage_id).items():
        if name.endswith(".scale"):
            state[name] = torch.ones(shape)
        elif name.endswith(".bias"):
            state[name] = torch.zeros(shape)
        else:
            state[name] = torch.randn(shape, generator=gen) / shape[1] ** 0.5
    return state


def _initial_state(cfg: MPMDConfig, stage_id: int) -> dict:
    """The state a stage starts from (:func:`init_stage_state`; a test
    that runs the stages as threads may swap this for converted JAX
    parameters)."""
    return init_stage_state(cfg, stage_id)


class Stage:
    """One stage's model, step and Adam (JAX's ``_build_stage_fns``):
    :meth:`forward` (no autograd), :meth:`backward` (recompute from the
    saved input, then the parameters' gradients, and the input's on a
    middle stage), :meth:`loss_grad` (the last stage: the loss, the
    parameters' and the input's gradients), :meth:`update` (Adam)."""

    def __init__(self, cfg: MPMDConfig, stage_id: int,
                 state: dict | None = None):
        from ..device import resolve_device
        from ..train.optimizers import adamw

        self.device = resolve_device(cfg.device)
        self.model = StageModel(cfg, stage_id, device=self.device)
        self.model.load_state_dict(
            _initial_state(cfg, stage_id) if state is None else state)
        self.params = list(self.model.parameters())
        self.opt = adamw(self.params, cfg.lr, weight_decay=0.0)

    def input(self, x) -> torch.Tensor:
        """A host array as this stage's input tensor (ids as int64)."""
        x = np.asarray(x)
        dtype = torch.long if x.dtype.kind in "iu" else torch.float32
        return torch.tensor(x, dtype=dtype, device=self.device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.model(x)

    def backward(self, x: torch.Tensor, dy: torch.Tensor):
        """The parameters' gradients (stage 0, whose input is the token
        ids) or ``(gradients, dx)``."""
        with torch.enable_grad():
            if x.dtype == torch.long:
                y = self.model(x)
                return list(torch.autograd.grad(y, self.params, dy))
            x = x.detach().requires_grad_(True)
            *gp, dx = torch.autograd.grad(self.model(x), [*self.params, x], dy)
            return gp, dx

    def loss_grad(self, x: torch.Tensor, ids: torch.Tensor):
        """``(loss, gradients, dx)``: the mean NLL of ``ids[:, 1:]`` under
        the log-softmax of ``logits[:, :-1]`` in fp32."""
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            logits = self.model(x)
            logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
            loss = -logp.gather(-1, ids[:, 1:, None]).mean()
            *gp, dx = torch.autograd.grad(loss, [*self.params, x])
            return loss.detach(), gp, dx

    def update(self, grads, scale: float) -> None:
        """Adam on the gradients times ``scale`` (1 / microbatches)."""
        for p, g in zip(self.params, grads):
            p.grad = g * scale
        self.opt.step()
        for p in self.params:
            p.grad = None


def _grads_add(acc, g):
    if acc is None:
        return list(g)
    return [a + b for a, b in zip(acc, g)]


def _make_ids(cfg: MPMDConfig, step: int, micro: int) -> np.ndarray:
    """A deterministic learnable LM microbatch (modular sequences),
    the same across restart attempts and byte-equal to JAX's."""
    r = np.random.default_rng(cfg.seed * 100003 + step * 1009 + micro)
    start = r.integers(0, cfg.vocab_size, (cfg.microbatch_size, 1))
    delta = r.integers(1, 7, (cfg.microbatch_size, 1))
    ids = (start + delta * np.arange(cfg.seq_len)) % cfg.vocab_size
    return ids.astype(np.int32)


def _observe_handoff(stage_id: int, tensors: dict, trace: dict | None,
                     trace_id: str) -> None:
    t_send = float(tensors["t_send"][()])
    dur = max(time.time() - t_send, 0.0)
    _H_HANDOFF.observe(dur, stage=str(stage_id))
    record_remote_span(
        "pipeline.handoff", t0=t_send, dur_s=dur,
        trace_id=(trace or {}).get("trace_id") or trace_id,
        parent_id=(trace or {}).get("span_id"), stage=stage_id,
        step=int(tensors["step"][()]), micro=int(tensors["micro"][()]))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _launches() -> collections.Counter:
    from ..ops import _cuda

    return collections.Counter(_cuda.launches)


def _stage_worker(cfg: MPMDConfig, stage_id: int, rdir: str, logdir: str,
                  trace_id: str):
    """One stage process's whole life: rendezvous, train loop, teardown.

    Runs inside a coordinator worker; any link failure raises
    :class:`WorkerUnavailableError`, so the closure re-queues (every
    stage restarts).  Returns ``{"stage", "started_at", "setup_seconds",
    "step_seconds", "launches"}`` (``started_at``: the closure's start,
    unix seconds; ``setup_seconds``: building the stage and the
    rendezvous; ``launches``: the port's kernel launches during the run,
    by name, a stage's own when the stages are processes), with
    ``"losses"`` (the per-step mean loss) on the last stage."""
    started_at, t0 = time.time(), time.monotonic()
    cfg.validate()
    first = stage_id == 0
    last = stage_id == cfg.n_stages - 1
    stage_dir = os.path.join(logdir, f"stage{stage_id}")
    os.makedirs(stage_dir, exist_ok=True)
    recorder = TraceRecorder(os.path.join(stage_dir, "trace.jsonl"),
                             chief_only=False).install()
    up = down = None
    losses: list[float] = []
    step_seconds: list[float] = []
    launches0 = _launches()
    # The stage's own metrics stream: a row an optimizer step with the
    # pipeline_* stamps and the registry's scalars (the handoff and stall
    # histograms): run_report and the schema checks read a stage dir as
    # a trainer's logdir.
    predicted_bubble = fb_schedule(cfg.n_stages,
                                   cfg.n_microbatches).bubble_fraction()
    metrics_path = os.path.join(stage_dir, "metrics.jsonl")
    # Each attempt trains from scratch (deterministic seeds), so the
    # stream starts over rather than appending to a dead attempt's rows.
    open(metrics_path, "w").close()

    def write_metrics_row(step: int, extra: dict) -> None:
        row = {"step": step, "t": time.time(), "pipeline_schedule": "mpmd",
               "pipeline_stages": cfg.n_stages,
               "pipeline_microbatches": cfg.n_microbatches,
               "pipeline_virtual": 1, "pipeline_bubble": predicted_bubble}
        try:
            row.update(obs.default_registry().scalars())
        except Exception:
            pass
        row.update(extra)
        with open(metrics_path, "a") as f:
            f.write(json.dumps(row) + "\n")

    try:
        stage = Stage(cfg, stage_id)
        setup = {"build": time.monotonic() - t0}
        # Rendezvous: every stage serves its upstream link first (stage
        # i accepts from i-1 on link i-1), then dials downstream; stage 0
        # only dials and the last stage only serves: no cycle.
        if not first:
            up = _Link(_serve_link(rdir, stage_id - 1, cfg.connect_timeout_s),
                       f"up{stage_id}", cfg.crc)
        if not last:
            down = _Link(_connect_link(rdir, stage_id, cfg.connect_timeout_s),
                         f"down{stage_id}", cfg.crc)
        setup["rendezvous"] = time.monotonic() - t0 - setup["build"]
        m_total = cfg.n_microbatches
        for step in range(cfg.n_steps):
            t_step0 = time.monotonic()
            grads = None
            if first:
                with remote_span("mpmd.step", step=step, stage=stage_id):
                    sent = done = 0
                    saved: dict[int, torch.Tensor] = {}
                    while done < m_total:
                        if sent < m_total and (sent - done) < cfg.window:
                            ids = _make_ids(cfg, step, sent)
                            x = stage.input(ids)
                            y = stage.forward(x)
                            saved[sent] = x
                            down.send({"x": _host(y), "ids": ids,
                                       "step": np.int32(step),
                                       "micro": np.int32(sent),
                                       "t_send": np.float64(time.time())},
                                      trace=current_context())
                            sent += 1
                            continue
                        window_blocked = sent < m_total
                        t0w = time.monotonic()
                        tens, _tr = down.recv(cfg.recv_timeout_s)
                        if window_blocked:
                            _H_STALL.observe(time.monotonic() - t0w,
                                             stage=str(stage_id))
                        x = saved.pop(int(tens["micro"][()]))
                        gp = stage.backward(x, stage.input(tens["dx"]))
                        grads = _grads_add(grads, gp)
                        done += 1
            elif not last:
                done = fwded = 0
                saved_x: dict[tuple[int, int], torch.Tensor] = {}

                def process_cot(tens, tr):
                    x_in = saved_x.pop((int(tens["step"][()]),
                                        int(tens["micro"][()])))
                    gp, dx = stage.backward(x_in, stage.input(tens["dx"]))
                    up.send({"dx": _host(dx), "step": tens["step"],
                             "micro": tens["micro"],
                             "t_send": np.float64(time.time())}, trace=tr)
                    return gp

                # Both directions are polled in one loop: blocking on the
                # upstream activation alone deadlocks a pipeline of 3 or
                # more stages (the windowed sender upstream waits for the
                # cotangents parked in our downstream queue).
                idle_deadline = time.monotonic() + cfg.recv_timeout_s
                while done < m_total:
                    if fwded > done:
                        got = down.poll(0.0)  # prefer cotangents (1F1B)
                        if got is not None:
                            grads = _grads_add(grads, process_cot(*got))
                            done += 1
                            idle_deadline = time.monotonic() + \
                                cfg.recv_timeout_s
                            continue
                    if fwded < m_total:
                        got = up.poll(0.002)
                        if got is not None:
                            tens, tr = got
                            _observe_handoff(stage_id, tens, tr, trace_id)
                            x_in = stage.input(tens["x"])
                            y = stage.forward(x_in)
                            saved_x[(int(tens["step"][()]),
                                     int(tens["micro"][()]))] = x_in
                            down.send({"x": _host(y),
                                       "ids": np.asarray(tens["ids"]),
                                       "step": tens["step"],
                                       "micro": tens["micro"],
                                       "t_send": np.float64(time.time())},
                                      trace=tr)
                            fwded += 1
                            idle_deadline = time.monotonic() + \
                                cfg.recv_timeout_s
                            continue
                    elif fwded > done:
                        got = down.poll(0.002)
                        if got is not None:
                            grads = _grads_add(grads, process_cot(*got))
                            done += 1
                            idle_deadline = time.monotonic() + \
                                cfg.recv_timeout_s
                            continue
                    if time.monotonic() > idle_deadline:
                        raise WorkerUnavailableError(
                            f"stage {stage_id}: no frames for "
                            f"{cfg.recv_timeout_s:.0f}s (dead pipeline?)")
            else:  # the last stage: the loss and its backward at once
                step_losses = []
                for _ in range(m_total):
                    tens, tr = up.recv(cfg.recv_timeout_s)
                    _observe_handoff(stage_id, tens, tr, trace_id)
                    loss, gp, dx = stage.loss_grad(
                        stage.input(tens["x"]), stage.input(tens["ids"]))
                    up.send({"dx": _host(dx), "step": tens["step"],
                             "micro": tens["micro"],
                             "t_send": np.float64(time.time())}, trace=tr)
                    grads = _grads_add(grads, gp)
                    step_losses.append(float(loss))
                losses.append(float(np.mean(step_losses)))
            stage.update(grads, 1.0 / m_total)
            step_seconds.append(time.monotonic() - t_step0)
            extra: dict = {"t_step": step_seconds[-1]}
            if last:
                extra["loss"] = losses[-1]
            write_metrics_row(step, extra)
        launches = _launches()
        launches.subtract(launches0)
        out: dict[str, Any] = {"stage": stage_id, "started_at": started_at,
                               "setup_seconds": setup,
                               "step_seconds": step_seconds,
                               "launches": dict(+launches)}
        if last:
            out["losses"] = losses
        return out
    except (ConnectionError, OSError, socket.timeout) as e:
        raise WorkerUnavailableError(
            f"stage {stage_id} link failure: {e!r}") from e
    finally:
        for link in (up, down):
            if link is not None:
                link.close()
        try:
            obs.default_registry().write_prometheus(
                os.path.join(stage_dir, "metrics.prom"))
        except Exception:
            pass
        recorder.uninstall()
        recorder.close()


def run_mpmd_pipeline(cfg: MPMDConfig, logdir: str, *,
                      coordinator: Coordinator | None = None,
                      join_timeout_s: float = 600.0) -> dict:
    """Drive an MPMD pipeline run to completion through the Coordinator.

    Schedules one stage closure a stage onto process workers (pass
    ``coordinator=`` to share one or kill its workers; otherwise an owned
    ``Coordinator(num_workers=n_stages, use_processes=True)`` is built
    and shut down).  Returns ``{"losses": [a step's mean loss...],
    "step_seconds", "trace_id", "stages", "logdir", "stage_results"}``
    (``stage_results``: each stage closure's return, in stage order); a
    stage killed mid-run re-queues every stage closure and the run
    completes on the respawned pool."""
    cfg.validate()
    os.makedirs(logdir, exist_ok=True)
    rdir = os.path.join(logdir, "rendezvous")
    os.makedirs(rdir, exist_ok=True)
    trace_id = new_trace_id()
    owns = coordinator is None
    coord = coordinator or Coordinator(num_workers=cfg.n_stages,
                                       use_processes=True)
    try:
        rvs = [coord.schedule(_stage_worker, (cfg, i, rdir, logdir, trace_id))
               for i in range(cfg.n_stages)]
        coord.join(timeout=join_timeout_s)
        results = [rv.fetch(timeout=30.0) for rv in rvs]
    finally:
        if owns:
            coord.shutdown()
    return {"losses": results[-1]["losses"],
            "step_seconds": results[-1]["step_seconds"],
            "trace_id": trace_id, "stages": cfg.n_stages, "logdir": logdir,
            "stage_results": results}


def reference_run(cfg: MPMDConfig, states: list | None = None
                  ) -> tuple[list, list]:
    """The run with every stage in this process and no link: ``(the
    per-step mean losses, the trained stages)``.  For each step and
    microbatch in order, the forward down the stages, the last stage's
    loss and backward, the cotangents up; each stage's gradients summed
    in microbatch order and its Adam step, as the pipeline applies them
    (``states``: each stage's initial state, default the seeded one)."""
    cfg.validate()
    stages = [Stage(cfg, i, None if states is None else states[i])
              for i in range(cfg.n_stages)]
    losses = []
    for step in range(cfg.n_steps):
        grads: list = [None] * cfg.n_stages
        step_losses = []
        for micro in range(cfg.n_microbatches):
            ids = _make_ids(cfg, step, micro)
            xs = [stages[0].input(ids)]
            for s in stages[:-1]:
                xs.append(s.input(_host(s.forward(xs[-1]))))
            last = stages[-1]
            loss, gp, dx = last.loss_grad(xs[-1], last.input(ids))
            grads[-1] = _grads_add(grads[-1], gp)
            step_losses.append(float(loss))
            for i in range(cfg.n_stages - 2, -1, -1):
                dy = stages[i].input(_host(dx))
                if i == 0:
                    grads[0] = _grads_add(grads[0],
                                          stages[0].backward(xs[0], dy))
                else:
                    gp, dx = stages[i].backward(xs[i], dy)
                    grads[i] = _grads_add(grads[i], gp)
        for s, g in zip(stages, grads):
            s.update(g, 1.0 / cfg.n_microbatches)
        losses.append(float(np.mean(step_losses)))
    return losses, stages


def batch_loss(cfg: MPMDConfig, stages: list, step: int) -> float:
    """The mean loss of ``step``'s microbatches through ``stages`` (no
    update)."""
    losses = []
    for micro in range(cfg.n_microbatches):
        ids = _make_ids(cfg, step, micro)
        x = stages[0].input(ids)
        for s in stages:
            x = s.forward(x)
        logp = torch.log_softmax(x[:, :-1].float(), dim=-1)
        tgt = stages[-1].input(ids)[:, 1:, None]
        losses.append(float(-logp.gather(-1, tgt).mean()))
    return float(np.mean(losses))
