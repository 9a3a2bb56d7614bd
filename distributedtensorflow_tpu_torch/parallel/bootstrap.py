"""Cluster bootstrap of the port: resolve the cluster, start the process
group.

Twin of ``distributedtensorflow_tpu/parallel/bootstrap.py``:
:class:`ClusterConfig` (``:31``), :func:`parse_tf_config` (``:49``),
:func:`expand_nodelist` (``:86``), the Slurm, MPI, Kubernetes, GCE and
SageMaker resolvers (``:149-321``) and :func:`resolve_cluster`
(``:323``), pure functions of an environment dict that give the JAX
package's ``ClusterConfig`` on the same dicts; :func:`initialize`
(``:397``) starts ``torch.distributed`` with a named backend, and
:func:`shutdown`, :func:`process_count`, :func:`process_index`,
:func:`is_chief`, :func:`barrier` and :func:`broadcast_from_chief`
(``:464``) follow.

torchrun's variables take the place of the JAX triple:
``MASTER_ADDR`` + ``MASTER_PORT`` that of ``JAX_COORDINATOR_ADDRESS``
("host:port"), ``MASTER_PORT`` alone that of ``JAX_COORDINATOR_PORT``,
``WORLD_SIZE`` of ``JAX_NUM_PROCESSES`` and ``RANK`` of
``JAX_PROCESS_ID``.  JAX's Cloud-TPU branch (``TPU_WORKER_HOSTNAMES``,
``auto``) has no counterpart.  Each process drives one card,
``cuda:<local rank>`` (:func:`local_rank`).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import socket

import torch

logger = logging.getLogger(__name__)

#: The coordinator port when the environment names none (JAX's default).
DEFAULT_PORT = 12321
BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Resolved cluster topology (``ClusterSpec``)."""

    coordinator_address: str | None = None  # "host:port" of process 0
    num_processes: int = 1
    process_id: int = 0

    @property
    def is_multiprocess(self) -> bool:
        return self.num_processes > 1


def parse_tf_config(tf_config_json: str) -> ClusterConfig:
    """A ``TF_CONFIG`` JSON blob as a :class:`ClusterConfig`: jobs flattened
    chief -> worker -> ps -> the rest (evaluators stand alone), the first
    task the coordinator."""
    cfg = json.loads(tf_config_json)
    cluster = cfg.get("cluster", {})
    task = cfg.get("task", {})
    ordered_jobs = [j for j in ("chief", "worker", "ps") if j in cluster]
    ordered_jobs += sorted(j for j in cluster
                           if j not in ("chief", "worker", "ps", "evaluator"))
    flat: list[str] = []
    offsets: dict[str, int] = {}
    for job in ordered_jobs:
        offsets[job] = len(flat)
        flat.extend(cluster[job])
    if not flat:
        return ClusterConfig()
    task_type = task.get("type", "worker")
    task_index = int(task.get("index", 0))
    if task_type == "evaluator":
        return ClusterConfig()
    return ClusterConfig(coordinator_address=flat[0],
                         num_processes=len(flat),
                         process_id=offsets.get(task_type, 0) + task_index)


def expand_nodelist(nodelist: str) -> list[str]:
    """A Slurm compact nodelist expanded: ``"n[001-003,07],login0"``;
    every ``[...]`` group of a name expands."""
    entries, depth, cur = [], 0, []
    for ch in nodelist:
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        if ch == "," and depth == 0:
            entries.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        entries.append("".join(cur))

    def expand_entry(entry: str) -> list[str]:
        m = re.fullmatch(r"([^\[]*)\[([^\]]+)\](.*)", entry)
        if not m:
            return [entry]
        prefix, body, suffix = m.groups()
        expanded: list[str] = []
        for part in body.split(","):
            if "-" in part:
                lo, hi = part.split("-")
                expanded.extend(f"{prefix}{i:0{len(lo)}d}{tail}"
                                for i in range(int(lo), int(hi) + 1)
                                for tail in expand_entry(suffix))
            else:
                expanded.extend(f"{prefix}{part}{tail}"
                                for tail in expand_entry(suffix))
        return expanded

    out: list[str] = []
    for entry in entries:
        out.extend(expand_entry(entry))
    return out


def _explicit_addr(env: dict[str, str]) -> str | None:
    """``MASTER_ADDR:MASTER_PORT`` (the port defaulting) when
    ``MASTER_ADDR`` is set."""
    host = env.get("MASTER_ADDR")
    if not host:
        return None
    return f"{host}:{int(env.get('MASTER_PORT', str(DEFAULT_PORT)))}"


def _coordinator_addr(env: dict[str, str], default_host: str,
                      coordinator_port: int) -> str:
    """An explicit ``MASTER_ADDR`` wins; else ``default_host`` with
    ``MASTER_PORT`` (or the resolver's default port)."""
    addr = _explicit_addr(env)
    if addr:
        return addr
    port = int(env.get("MASTER_PORT", str(coordinator_port)))
    return f"{default_host}:{port}"


def resolve_slurm(env: dict[str, str], *,
                  coordinator_port: int = DEFAULT_PORT
                  ) -> ClusterConfig | None:
    """One process per Slurm task; the coordinator is the first node of
    ``SLURM_STEP_NODELIST`` (else ``SLURM_JOB_NODELIST``).  A single task
    falls through."""
    if "SLURM_PROCID" not in env:
        return None
    ntasks = int(env.get("SLURM_STEP_NUM_TASKS", env.get("SLURM_NTASKS", "1")))
    if ntasks <= 1:
        return None
    addr = _explicit_addr(env)
    if not addr:
        nodelist = env.get("SLURM_STEP_NODELIST",
                           env.get("SLURM_JOB_NODELIST", ""))
        nodes = expand_nodelist(nodelist) if nodelist else []
        if not nodes:
            return None
        addr = _coordinator_addr(env, nodes[0], coordinator_port)
    return ClusterConfig(coordinator_address=addr, num_processes=ntasks,
                         process_id=int(env["SLURM_PROCID"]))


def resolve_mpi(env: dict[str, str]) -> ClusterConfig | None:
    """An OpenMPI launch (``OMPI_COMM_WORLD_*``); the coordinator address
    must come from ``MASTER_ADDR``."""
    if "OMPI_COMM_WORLD_RANK" not in env:
        return None
    size = int(env.get("OMPI_COMM_WORLD_SIZE", "1"))
    if size <= 1:
        return None
    addr = _explicit_addr(env)
    if not addr:
        return None
    return ClusterConfig(coordinator_address=addr, num_processes=size,
                         process_id=int(env["OMPI_COMM_WORLD_RANK"]))


def resolve_kubernetes(env: dict[str, str], *,
                       coordinator_port: int = DEFAULT_PORT
                       ) -> ClusterConfig | None:
    """A Kubernetes pod: rank from ``JOB_COMPLETION_INDEX`` (Indexed Job)
    or the hostname's ``-<n>`` ordinal (StatefulSet), world size from
    ``K8S_NUM_PODS``, coordinator pod 0 through ``K8S_HEADLESS_SERVICE``
    unless ``MASTER_ADDR`` says otherwise."""
    if "KUBERNETES_SERVICE_HOST" not in env:
        return None
    num = int(env.get("K8S_NUM_PODS", "0"))
    if num <= 1:
        return None
    m = re.fullmatch(r"(.*)-(\d+)", env.get("HOSTNAME", ""))
    if "JOB_COMPLETION_INDEX" in env:
        rank = int(env["JOB_COMPLETION_INDEX"])
    elif m:
        rank = int(m.group(2))
    else:
        return None
    addr = _explicit_addr(env)
    if not addr:
        svc = env.get("K8S_HEADLESS_SERVICE")
        if not svc or not m:
            return None
        addr = _coordinator_addr(env, f"{m.group(1)}-0.{svc}",
                                 coordinator_port)
    if not 0 <= rank < num:
        raise ValueError(
            f"K8s pod ordinal {rank} out of range for K8S_NUM_PODS={num}")
    return ClusterConfig(coordinator_address=addr, num_processes=num,
                         process_id=rank)


def resolve_gce(env: dict[str, str], *,
                coordinator_port: int = DEFAULT_PORT
                ) -> ClusterConfig | None:
    """A GCE instance group snapshotted into ``GCE_INSTANCE_GROUP_HOSTS``:
    rank from ``GCE_TASK_INDEX`` or this instance's place in the list, the
    first instance the coordinator."""
    hosts = [h for h in env.get("GCE_INSTANCE_GROUP_HOSTS", "").split(",")
             if h]
    if len(hosts) <= 1:
        return None
    if "GCE_TASK_INDEX" in env:
        rank = int(env["GCE_TASK_INDEX"])
    else:
        name = env.get("GCE_INSTANCE_NAME") or env.get("HOSTNAME", "")
        short = {h.split(".")[0]: i for i, h in enumerate(hosts)}
        rank = short.get(name.split(".")[0], -1)
        if rank < 0:
            return None
    if not 0 <= rank < len(hosts):
        raise ValueError(f"GCE_TASK_INDEX={rank} out of range for "
                         f"{len(hosts)} instance-group hosts")
    return ClusterConfig(
        coordinator_address=_coordinator_addr(env, hosts[0],
                                              coordinator_port),
        num_processes=len(hosts), process_id=rank)


def resolve_sagemaker(env: dict[str, str], *,
                      coordinator_port: int = DEFAULT_PORT
                      ) -> ClusterConfig | None:
    """SageMaker: ``SM_HOSTS`` (a JSON list of hostnames) and
    ``SM_CURRENT_HOST``; the first host in sorted order coordinates."""
    raw = env.get("SM_HOSTS")
    if not raw:
        return None
    try:
        decoded = json.loads(raw)
    except json.JSONDecodeError:
        return None
    if not isinstance(decoded, list) or not all(
            isinstance(h, str) for h in decoded):
        return None
    hosts = sorted(decoded)
    current = env.get("SM_CURRENT_HOST", "")
    if len(hosts) <= 1 or current not in hosts:
        return None
    return ClusterConfig(
        coordinator_address=_coordinator_addr(env, hosts[0],
                                              coordinator_port),
        num_processes=len(hosts), process_id=hosts.index(current))


def resolve_cluster(env: dict[str, str] | None = None) -> ClusterConfig:
    """The cluster from the environment, in the JAX package's order:
    torchrun's variables (``MASTER_ADDR`` with ``RANK`` or
    ``WORLD_SIZE``), ``TF_CONFIG``, Slurm, MPI, Kubernetes, GCE,
    SageMaker; else one local process."""
    env = dict(os.environ if env is None else env)
    saw_dangling_addr = False
    if env.get("MASTER_ADDR"):
        if "RANK" in env or "WORLD_SIZE" in env:
            rank = env.get("RANK") or env.get("SLURM_PROCID") or env.get(
                "OMPI_COMM_WORLD_RANK") or env.get(
                "JOB_COMPLETION_INDEX") or env.get("GCE_TASK_INDEX") or "0"
            cfg = ClusterConfig(coordinator_address=_explicit_addr(env),
                                num_processes=int(env.get("WORLD_SIZE", "1")),
                                process_id=int(rank))
            if cfg.process_id >= cfg.num_processes:
                raise ValueError(
                    f"RANK={cfg.process_id} out of range for WORLD_SIZE="
                    f"{cfg.num_processes}; multi-process launches must "
                    "export WORLD_SIZE on every rank")
            if "RANK" not in env and cfg.num_processes > 1:
                logger.warning(
                    "RANK missing; derived process_id=%d (from scheduler "
                    "env, or 0). Every process in this job must resolve a "
                    "distinct rank or the job will not form.",
                    cfg.process_id)
            return cfg
        saw_dangling_addr = True
    if env.get("TF_CONFIG"):
        return parse_tf_config(env["TF_CONFIG"])
    for resolver in (resolve_slurm, resolve_mpi, resolve_kubernetes,
                     resolve_gce, resolve_sagemaker):
        cfg = resolver(env)
        if cfg is not None:
            return cfg
    if saw_dangling_addr:
        logger.warning(
            "MASTER_ADDR set but RANK/WORLD_SIZE are absent and no "
            "scheduler env (TF_CONFIG/Slurm/MPI/K8s/GCE/SageMaker) resolved "
            "a cluster; treating as local")
    return ClusterConfig()


def local_rank(env: dict[str, str] | None = None) -> int:
    """This process's index on its host: ``LOCAL_RANK`` (torchrun),
    ``SLURM_LOCALID`` or ``OMPI_COMM_WORLD_LOCAL_RANK``; 0 without."""
    env = os.environ if env is None else env
    for key in ("LOCAL_RANK", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK"):
        if key in env:
            return int(env[key])
    return 0


def local_device(device="cuda", env: dict[str, str] | None = None
                 ) -> torch.device:
    """``cuda:<local rank>`` for a CUDA ``device`` given without an index
    (raises when this host has no such card); any other device as
    given."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    idx = local_rank(env)
    if idx >= torch.cuda.device_count():
        raise RuntimeError(
            f"local rank {idx} has no card: this host has "
            f"{torch.cuda.device_count()} CUDA device(s)")
    return torch.device("cuda", idx)


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize(cluster: ClusterConfig | None = None, *,
               backend: str) -> ClusterConfig:
    """Start the default process group over ``cluster`` (default: the
    resolved one) with ``backend`` ("nccl" or "gloo", never guessed).
    One local process gets a group of one at a free localhost port, so a
    mesh of one runs the same collectives.  Idempotent."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    cluster = cluster or resolve_cluster()
    if torch.distributed.is_initialized():
        return cluster
    addr = cluster.coordinator_address if cluster.is_multiprocess \
        else f"127.0.0.1:{free_port()}"
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{addr}",
        world_size=cluster.num_processes, rank=cluster.process_id)
    logger.info("process group up (%s): process %d/%d, coordinator %s",
                backend, cluster.process_id, cluster.num_processes, addr)
    return cluster


def shutdown() -> None:
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def process_count() -> int:
    return torch.distributed.get_world_size() \
        if torch.distributed.is_initialized() else 1


def process_index() -> int:
    return torch.distributed.get_rank() \
        if torch.distributed.is_initialized() else 0


def is_chief() -> bool:
    """Process 0 writes metrics and checkpoints."""
    return process_index() == 0


def barrier() -> None:
    """Every process waits for the others; a no-op for one process."""
    if process_count() > 1:
        torch.distributed.barrier()


def broadcast_from_chief(obj):
    """Process 0's picklable ``obj`` on every process (a no-op for one)."""
    if process_count() <= 1:
        return obj
    box = [obj if is_chief() else None]
    torch.distributed.broadcast_object_list(box, src=0)
    return box[0]
