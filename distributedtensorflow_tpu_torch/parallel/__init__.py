"""Parallelism of the port: the mesh's data axis (``mesh``), the cluster
bootstrap (``bootstrap``), the collectives (``collectives``) and the MoE
layer (``moe``)."""

from .moe import ROUTERS, local_moe, top1_route, top2_route  # noqa: F401
