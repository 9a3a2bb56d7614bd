"""Checkpoint and resume of the port, with integrity verification
(``checkpoint/``: the manager, the manifests, the preemption handler)."""

from .integrity import CheckpointCorruptError  # noqa: F401
from .manager import CheckpointManager  # noqa: F401
from .preemption import PreemptionHandler  # noqa: F401
