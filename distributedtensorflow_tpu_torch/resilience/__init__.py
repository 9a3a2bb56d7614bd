"""Self-healing training.

Twin of ``distributedtensorflow_tpu/resilience/``, less its elastic
resize (``elastic.py``, ``--elastic``), which is not ported yet:

- **checkpoint integrity** (``checkpoint/integrity.py`` and the
  ``CheckpointManager``): CRC32 manifests at save; ``restore_latest``
  verifies and falls back past truncated or corrupt steps;
- **supervision** (:mod:`.supervisor`): bounded-retry restarts with
  exponential backoff around ``Trainer.fit``: classify, restore the last
  verified checkpoint into the live state, re-enter, and escalate to a
  clean non-zero exit when the budget runs out;
- **fault injection** (:mod:`.chaos`): deterministic fault plans
  (``train_torch.py --fault-plan``) that exercise the whole stack,
  logging every injection and recovery to ``<logdir>/faults.jsonl``.
"""

from .chaos import (  # noqa: F401
    FAULT_KINDS,
    NET_FAULT_KINDS,
    ChaosInjector,
    DataStallFault,
    FaultPlan,
    InjectedFault,
    WorkerKilledFault,
)
from .supervisor import (  # noqa: F401
    RestartBudgetExhausted,
    Supervisor,
    SupervisorConfig,
    classify_failure,
)
