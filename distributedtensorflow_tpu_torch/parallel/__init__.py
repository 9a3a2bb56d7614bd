"""Parallelism of the port: the mesh and its batch and model groups
(``mesh``), the cluster bootstrap (``bootstrap``), the collectives
(``collectives``), the layout rules and tensor parallelism
(``sharding``), ZeRO (``zero``), the overlapped gradient sync
(``overlap``) and the MoE layer (``moe``)."""

from .moe import ROUTERS, local_moe, top1_route, top2_route  # noqa: F401
