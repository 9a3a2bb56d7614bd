"""distributedtensorflow_tpu_torch — the PyTorch/CUDA port.

A second package beside the JAX reference ``distributedtensorflow_tpu``
with the same module layout, so every ported file has a twin it is
checked against (``tests/test_torch_*.py``).  It imports ``torch`` and
``numpy`` only — never ``jax`` nor any module of the JAX package.

Ported so far:

- the serving path of GPT-2-small: the decode-mode model (``models``),
  dense-cache ``generate``, and the paged continuous-batching
  ``serve.Engine``;
- the training step of the GPT presets and the BASELINE.json workloads
  (``workloads``, ``train``, ``data``; the ``train_torch.py`` CLI), on one
  device or data-parallel over ranks (``parallel``: the mesh, the cluster
  bootstrap, the collectives);
- checkpoint and resume (``checkpoint``);
- ``train.py``'s fit loop, ``train.Trainer``, and the telemetry it
  carries (``obs``: registry, spans, anomaly detector, flight recorder,
  goodput, memory, MFU, reactive profiling, status server);
- host-side distribution: the closure dispatcher, the sidecar
  evaluator and the async parameter server (``parallel.coordinator``,
  ``train.sidecar``, ``parallel.param_server``), the host ring
  collectives (``native.HostCollectives``), the multi-process runner
  (``testing.multi_process_runner``), the strategy classes
  (``strategies``) and the MPMD stage-per-process pipeline
  (``parallel.pipeline_mpmd``).

The hand-written Hopper kernels live in ``csrc/``: the LayerNorm forward
and backward (``ops.layernorm``), single-token decode attention
(``ops.attention``) and flash attention forward and backward
(``ops.flash_attention``).  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"`` (:func:`device.resolve_device`).
"""

__version__ = "0.2.0"

from . import strategies  # noqa: F401,E402  (the reference's strategy zoo)
