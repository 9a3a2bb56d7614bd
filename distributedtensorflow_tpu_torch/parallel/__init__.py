"""Parallelism of the port: the mesh and its groups (``mesh``), the
cluster bootstrap (``bootstrap``), the collectives (``collectives``), the
layout rules and tensor parallelism (``sharding``), ZeRO (``zero``), the
overlapped gradient sync (``overlap``), the MoE layer and its
expert-parallel region (``moe``), sequence parallelism
(``ring_attention``) and the pipeline schedules (``pipeline``)."""

from .moe import ROUTERS, local_moe, top1_route, top2_route  # noqa: F401
