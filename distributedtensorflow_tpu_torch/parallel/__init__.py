"""Parallelism of the port: so far the single-device MoE layer."""

from .moe import ROUTERS, local_moe, top1_route, top2_route  # noqa: F401
